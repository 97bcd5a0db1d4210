"""BaseTrainer: orchestration around the train step (counterpart of
diffmining_tpu/finetuning/base.py; reference finetuning/base.py and the
per-domain trainers cars.py/ftt.py/geo.py/places.py, xray/finetune.py).

One trainer covers every domain; the per-domain deltas (dataset, prompts,
crop) live in datasets.py and ``RESOLUTIONS``; the sampling prompts of the
reference's previews come with them (ROADMAP A10). Two
checkpoint tiers, as in the reference (SURVEY.md §5.4):

  * training checkpoints ``checkpoint-{N}/state.pt`` (``torch.save`` of the
    UNet parameters, optimizer state and EMA; N counts optimizer steps),
    written under a temporary name and renamed into place, so a
    ``checkpoint-N`` directory is complete by construction; resume with
    ``--resume_from_checkpoint latest``, prune with
    ``--checkpoints_total_limit``;
  * the final (or ``--export-only``) export to a diffusers pipeline dir,
    which the typicality stage reads.

Models come from ``--base_name_or_path`` (a pipeline dir) or an injected
bundle ``sd`` with ``unet``, ``vae``, ``clip``, ``tokenizer`` and
``schedule`` (e.g. ``typicality.compute.SD.init_random``). ``load`` replaces
image decoding (``path -> [H, W, 3] float32 in [-1, 1]``), as the sweep's
``compute_submission(load=...)`` does.
"""
from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
from os.path import join
from typing import Any, Dict, List, Optional

import torch

from diffmining_tpu_torch.finetuning.args import check_supported
from diffmining_tpu_torch.finetuning.datasets import DATASETS, BatchIterator, Loader
from diffmining_tpu_torch.finetuning.train import (
    AccumulateState,
    AdamWState,
    TrainStepBuilder,
    make_lr_schedule,
    make_optimizer,
)
from diffmining_tpu_torch.models.clip import CLIPTextModel
from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffmining_tpu_torch.models.unet import UNet2DCondition
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, AutoencoderKL
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.observability import MetricsLogger, StepTimer
from diffmining_tpu_torch.utils.weights import (
    _read_json,
    clip_config_from_json,
    load_pipeline_dir,
    load_state,
    read_safetensors_dir,
    to_state_dict,
)

logger = logging.getLogger("diffmining_tpu_torch.finetune")
CKPT = re.compile(r"checkpoint-(\d+)$")
CKPT_TMP = re.compile(r"checkpoint-\d+\.tmp-\d+$")  # save_checkpoint's temporary names


# each domain's crop size when --resolution is not given (reference
# cars.py, ftt.py: 256; geo.py, places.py, xray/finetune.py: 512)
RESOLUTIONS: Dict[str, int] = {"cars": 256, "ftt": 256, "geo": 512, "places": 512, "xray": 512}


class BaseTrainer:
    def __init__(self, which: str, args, sd=None, load: Optional[Loader] = None):
        check_supported(args)
        if which not in RESOLUTIONS:
            raise ValueError(f"unknown domain {which!r}; expected one of {sorted(RESOLUTIONS)}")
        self.which = which
        self.args = args
        self.device = resolve_device(args.device)
        self.load = load
        self._init_models(sd)

    # ------------------------------------------------------------------

    def _init_models(self, sd=None):
        args = self.args
        self.vae_decoder: Dict[str, torch.Tensor] = {}  # the base's decoder tensors, exported as they are
        self.base_dir = None
        if sd is not None:
            self.unet, self.vae, self.clip = sd.unet, sd.vae, sd.clip
            self.tokenizer, self.schedule = sd.tokenizer, sd.schedule
        elif os.path.isdir(args.base_name_or_path):
            self.base_dir = base = args.base_name_or_path
            p = load_pipeline_dir(base)
            self.unet = UNet2DCondition(p["unet"]["config"])
            load_state(self.unet, p["unet"]["state_dict"])
            self.vae = AutoencoderKL(p["vae"]["config"])
            load_state(self.vae, p["vae"]["state_dict"], ignore_prefixes=DECODER_PREFIXES)
            self.vae_decoder = {k: v for k, v in p["vae"]["state_dict"].items() if k.startswith(DECODER_PREFIXES)}
            self.clip = CLIPTextModel(p["text_encoder"]["config"])
            load_state(self.clip, p["text_encoder"]["state_dict"])
            self.schedule = p["schedule"]
            tok_dir = p["tokenizer_dir"]
            if os.path.isfile(join(tok_dir, "vocab.json")):
                self.tokenizer = CLIPTokenizer.from_pretrained_dir(tok_dir)
            else:
                self.tokenizer = tiny_tokenizer(p["text_encoder"]["config"].vocab_size)
        else:
            raise FileNotFoundError(
                f"--base_name_or_path {args.base_name_or_path!r} is not a local pipeline dir; there is "
                "no network here to fetch a hub checkpoint"
            )
        if args.clip_path:  # e.g. StreetCLIP for geo (reference geo.py:51)
            self.clip = CLIPTextModel(clip_config_from_json(_read_json(join(args.clip_path, "config.json"))))
            tensors = read_safetensors_dir(args.clip_path)
            load_state(self.clip, to_state_dict({k: v for k, v in tensors.items() if k.startswith("text_model.")}))
        # float32 master weights for the UNet; the frozen towers keep their dtype
        self.unet.to(device=self.device, dtype=torch.float32)
        self.vae.to(self.device)
        self.clip.to(self.device)
        self.schedule = self.schedule.to(self.device)
        if args.gradient_checkpointing:
            self.unet.set_gradient_checkpointing(args.gradient_checkpointing_policy)

    # ------------------------------------------------------------------

    def init_dataloader(self):
        args = self.args
        ds = DATASETS[self.which](args.data_path, self.tokenizer, seed=args.seed, load=self.load)
        if args.random_subset:
            import random

            ids = random.Random(42).sample(range(len(ds)), args.random_subset)
            ds.items = [ds.items[i] for i in ids]
        ds.resolution = args.resolution or RESOLUTIONS[self.which]
        self.train_dataset = ds
        self.loader = BatchIterator(ds, args.train_batch_size, seed=args.seed)

    def _builder(self, optimizer) -> TrainStepBuilder:
        args = self.args
        return TrainStepBuilder(
            unet=self.unet, vae=self.vae, clip=self.clip, schedule=self.schedule, optimizer=optimizer,
            use_ema=args.use_ema, ema_max_decay=args.ema_decay, mixed_precision=args.mixed_precision != "no",
        )

    def training_init(self):
        args = self.args
        self.init_dataloader()
        self.num_update_steps_per_epoch = max(1, math.ceil(len(self.loader) / args.gradient_accumulation_steps))
        if args.max_train_steps is None:
            args.max_train_steps = args.num_train_epochs * self.num_update_steps_per_epoch
        args.num_train_epochs = math.ceil(args.max_train_steps / self.num_update_steps_per_epoch)
        if args.logging_steps is None:
            args.logging_steps = max(1, self.num_update_steps_per_epoch // 2)
        if args.checkpointing_steps is None:
            args.checkpointing_steps = max(1, self.num_update_steps_per_epoch // 2)

        lr = args.learning_rate
        if args.scale_lr:
            lr *= args.gradient_accumulation_steps * args.train_batch_size
        self.optimizer = make_optimizer(
            make_lr_schedule(args.lr_scheduler, lr, args.lr_warmup_steps, args.max_train_steps),
            args.adam_beta1, args.adam_beta2, args.adam_weight_decay, args.adam_epsilon, args.max_grad_norm,
            args.gradient_accumulation_steps,
            accum_dtype=torch.bfloat16 if args.gradient_accumulation_dtype == "bf16" else None,
        )
        self.builder = self._builder(self.optimizer)
        self.state = self.builder.init_state()
        self.train_step = self.builder.build()
        self.global_step = 0  # optimizer steps (reference cars.py:286)
        self.micro_step = 0  # train_step calls == state.step
        self.first_epoch = 0
        self.resume_step = 0

    def export_init(self):
        """Optimizer-only init for --export-only: no dataloader (the
        reference's export fast path, places.py:136-189)."""
        self.num_update_steps_per_epoch = 1
        self.optimizer = make_optimizer(make_lr_schedule("constant", self.args.learning_rate, 0))
        self.builder = self._builder(self.optimizer)
        self.state = self.builder.init_state()
        self.global_step = self.micro_step = self.first_epoch = self.resume_step = 0

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def _ckpt_dir(self, step: int) -> str:
        return join(self.args.output_dir, f"checkpoint-{step}")

    def _complete_checkpoints(self) -> List[str]:
        """Complete checkpoint dirs, oldest first."""
        out = self.args.output_dir
        names = [d for d in os.listdir(out) if CKPT.match(d) and os.path.isfile(join(out, d, "state.pt"))]
        return sorted(names, key=lambda d: int(CKPT.match(d).group(1)))

    def _prune_checkpoints(self, limit: Optional[int]) -> None:
        """Delete leftovers of interrupted writes (``checkpoint-N`` with no
        state.pt, ``checkpoint-N.tmp-PID``) and, with a limit, all but the
        newest ``limit`` complete checkpoints. Other names are left alone,
        among them the ``checkpoint-N-export`` pipeline dirs that
        finetuning/export.py writes beside the checkpoints."""
        out = self.args.output_dir
        complete = self._complete_checkpoints()
        drop = [d for d in os.listdir(out)
                if (CKPT.match(d) and d not in complete) or CKPT_TMP.match(d)]
        if limit:
            drop += complete[:-limit]
        for d in drop:
            shutil.rmtree(join(out, d))

    def _state_dict(self) -> Dict[str, Any]:
        st = self.state
        opt = st.opt_state
        inner = opt.inner_state if isinstance(opt, AccumulateState) else opt
        saved = {
            "step": st.step,
            "params": st.params,
            "ema_params": st.ema_params,
            "adam": {"count": inner.count, "mu": inner.mu, "nu": inner.nu},
        }
        if isinstance(opt, AccumulateState):
            saved["accum"] = {"mini_step": opt.mini_step, "gradient_step": opt.gradient_step, "acc": opt.acc}
        return saved

    def save_checkpoint(self, step: int) -> None:
        """Write checkpoint-{step}/state.pt under a temporary name, then
        rename it into place; prune before and after, so the newest complete
        checkpoint survives a crash at any point."""
        path = self._ckpt_dir(step)
        limit = self.args.checkpoints_total_limit
        self._prune_checkpoints(limit)
        if os.path.isfile(join(path, "state.pt")):
            return  # already saved at this step (end-of-training re-save)
        tmp = f"{path}.tmp-{os.getpid()}"
        os.makedirs(tmp)
        torch.save(self._state_dict(), join(tmp, "state.pt"))
        os.replace(tmp, path)
        logger.info("Saved state to %s", path)
        self._prune_checkpoints(limit)

    def resume_training(self, params_only: bool = False) -> None:
        args = self.args
        if not args.resume_from_checkpoint:
            return
        if args.resume_from_checkpoint != "latest":
            path = args.resume_from_checkpoint
            if not os.path.isdir(path):
                path = join(args.output_dir, os.path.basename(path))
        else:
            done = self._complete_checkpoints()
            path = join(args.output_dir, done[-1]) if done else None
        if path is None or not os.path.isfile(join(path, "state.pt")):
            logger.info("Checkpoint %r does not exist. Starting fresh.", args.resume_from_checkpoint)
            return
        saved = torch.load(join(path, "state.pt"), map_location=self.device, weights_only=True)
        st = self.state
        with torch.no_grad():
            for k, v in saved["params"].items():
                st.params[k].copy_(v)
            if st.ema_params is not None and saved["ema_params"] is not None:
                for k, v in saved["ema_params"].items():
                    st.ema_params[k].copy_(v)
            if not params_only:
                opt = st.opt_state
                inner: AdamWState = opt.inner_state if isinstance(opt, AccumulateState) else opt
                inner.count = saved["adam"]["count"]
                torch._foreach_copy_(inner.mu, saved["adam"]["mu"])
                torch._foreach_copy_(inner.nu, saved["adam"]["nu"])
                if isinstance(opt, AccumulateState) and "accum" in saved:
                    opt.mini_step = saved["accum"]["mini_step"]
                    opt.gradient_step = saved["accum"]["gradient_step"]
                    torch._foreach_copy_(opt.acc, saved["accum"]["acc"])
        st.step = saved["step"]
        # state.step counts train_step calls (micro-steps); global_step is in
        # optimizer steps; the epoch position is in micro-batches (no loader
        # under --export-only)
        self.micro_step = st.step
        self.global_step = self.micro_step // args.gradient_accumulation_steps
        loader = getattr(self, "loader", None)
        batches_per_epoch = max(1, len(loader)) if loader is not None else 1
        self.first_epoch = self.micro_step // batches_per_epoch
        self.resume_step = self.micro_step % batches_per_epoch
        logger.info("Resumed from %s at optimizer step %d", path, self.global_step)

    # ------------------------------------------------------------------

    def end_training(self) -> str:
        args = self.args
        export_dir = args.export_dir or join(args.output_dir, "export")
        save_pipeline_dir(
            export_dir,
            self.unet.config, self.builder.dense_params(self.state, use_ema=args.use_ema),
            self.vae.config, {**self.vae.state_dict(), **self.vae_decoder},
            self.clip.config, self.clip.state_dict(),
            self.schedule,
            tokenizer_src_dir=join(self.base_dir, "tokenizer") if self.base_dir else None,
        )
        logger.info("Exported pipeline to %s", export_dir)
        return export_dir

    def _batch(self, batch) -> tuple:
        images = torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).to(self.device)
        return images, torch.from_numpy(batch["tokenized"]).long().to(self.device)

    def train(self) -> str:
        args = self.args
        os.makedirs(args.output_dir, exist_ok=True)
        if args.export_only:
            self.export_init()
            self.resume_training(params_only=True)
            return self.end_training()
        self.training_init()
        self.resume_training()
        with open(join(args.output_dir, "trainer_args.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

        # the loss stays on the device; one host read per logging window
        losses: List[torch.Tensor] = []
        timer = StepTimer()
        # global_step counts OPTIMIZER steps (accumulation-window boundaries),
        # like the reference's accelerate loop (cars.py:286): max_train_steps,
        # checkpointing_steps and logging_steps are in those units
        accum = args.gradient_accumulation_steps
        done = False
        with MetricsLogger(join(args.output_dir, args.logging_dir, "metrics.jsonl")) as metrics:
            for epoch in range(self.first_epoch, args.num_train_epochs):
                for step, batch in enumerate(self.loader.epoch(epoch)):
                    if epoch == self.first_epoch and step < self.resume_step:
                        continue
                    self.state, loss = self.train_step(self.state, *self._batch(batch), args.seed)
                    self.micro_step += 1
                    losses.append(loss)
                    del losses[:-50]
                    timer.tick()
                    if self.micro_step % accum != 0:
                        continue  # mid-window micro-step: no optimizer update
                    self.global_step += 1
                    if self.global_step % args.checkpointing_steps == 0:
                        self.save_checkpoint(self.global_step)
                    if self.global_step % args.logging_steps == 0:
                        mean_loss = float(torch.stack(losses).mean())
                        logger.info("step %d loss %.4f", self.global_step, mean_loss)
                        metrics.log(self.global_step, train_loss=mean_loss, epoch=epoch,
                                    steps_per_sec=timer.steps_per_sec())
                    if self.global_step >= args.max_train_steps:
                        done = True
                        break
                if done:
                    break
        self.save_checkpoint(self.global_step)
        return self.end_training()
