"""BaseTrainer: orchestration around the train step (counterpart of
diffmining_tpu/finetuning/base.py; reference finetuning/base.py and the
per-domain trainers cars.py/ftt.py/geo.py/places.py, xray/finetune.py).

One trainer covers every domain; the per-domain deltas (dataset, prompts,
crop) live in datasets.py and ``DOMAINS`` (the crop size and the preview
prompts). ``--log_previews`` samples each preview category with DDIM and
classifier-free guidance (``sample``) at every logging step and at the
end, and ``save_logs`` writes one grid a category under
``{output_dir}/plots/{step}/``. Two checkpoint tiers, as in the reference
(SURVEY.md §5.4):

  * training checkpoints ``checkpoint-{N}/state.pt`` (``torch.save`` of the
    UNet parameters or, under --lora, the factors; the optimizer state, the
    int8 moments and their scales under --use_8bit_adam; the EMA; N counts
    optimizer steps),
    written under a temporary name and renamed into place, so a
    ``checkpoint-N`` directory is complete by construction; resume with
    ``--resume_from_checkpoint latest``, prune with
    ``--checkpoints_total_limit``;
  * the final (or ``--export-only``) export to a diffusers pipeline dir,
    which the typicality stage reads.

Over a mesh (``--distributed`` under torchrun, ``--mesh_dp``,
``--mesh_fsdp``; JAX base.py:88-95, 163-172, 212-239) ``--train_batch_size``
is the global batch: each rank decodes its dp share of every batch, the
step all-reduces the gradients (finetuning/train.py), and fsdp > 1 shards
the optimizer state and the EMA. Rank 0 alone writes ``trainer_args.json``,
the metrics, the preview grids, the checkpoints and the export. A
checkpoint keeps the one-process format whatever the mesh: rank 0 writes
the whole state, the fsdp pieces gathered tensor by tensor to the host, and
each rank of a resuming run (any mesh) copies in its own piece.

Models come from ``--base_name_or_path`` (a pipeline dir) or an injected
bundle ``sd`` with ``unet``, ``vae``, ``clip``, ``tokenizer`` and
``schedule`` (e.g. ``typicality.compute.SD.init_random``). ``load`` replaces
image decoding (``path -> [H, W, 3] float32 in [-1, 1]``), as the sweep's
``compute_submission(load=...)`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import shutil
from os.path import join
from typing import Any, Dict, List, Optional

import torch

from diffmining_tpu_torch.diffusion.sampling import sample_ddim
from diffmining_tpu_torch.finetuning.args import trainer_mesh
from diffmining_tpu_torch.finetuning.datasets import DATASETS, BatchIterator, Loader
from diffmining_tpu_torch.finetuning.train import (
    AccumulateState,
    TrainStepBuilder,
    make_lr_schedule,
    make_optimizer,
)
from diffmining_tpu_torch.models.clip import CLIPTextModel
from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffmining_tpu_torch.models.unet import UNet2DCondition
from diffmining_tpu_torch.models.vae import AutoencoderKL
from diffmining_tpu_torch.ops import optim8bit
from diffmining_tpu_torch.ops.optim8bit import Adam8bitState
from diffmining_tpu_torch.parallel.mesh import Mesh, host_barrier, host_local_batch_slice, is_writer
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.export import save_pipeline_dir
from diffmining_tpu_torch.utils.figures import hcat
from diffmining_tpu_torch.utils.images import tensor_to_images
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


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """A domain's preview prompts and its crop size when --resolution is not
    given (the JAX package's DomainSpec, finetuning/base.py:48)."""

    sample_categories: tuple
    sample_prompt: str  # .format(c=category)
    negative_prompt: str
    resolution: int


DOMAINS: Dict[str, DomainSpec] = {
    # reference cars.py:107,246
    "cars": DomainSpec(("1880", "1940", "1980", "2000", "2010"), "A car at the {c}s.", "A car", 256),
    # ftt.py:97,242
    "ftt": DomainSpec(("1880", "1920", "1940", "1960", "1980", "2000"),
                      "A face portrait from the {c}s.", "A face portrait", 256),
    # geo.py:111,255
    "geo": DomainSpec(("France", "Japan", "United States", "Brazil", "India", "Italy", "Nigeria", "Russia",
                       "Thailand", "United Kingdom"),
                      "A google street view image in {c}", "A google street view image", 512),
    # places.py:254
    "places": DomainSpec((), "An image of {c}.", "", 512),
    # xray/finetune.py
    "xray": DomainSpec(("no finding", "Cardiomegaly", "Effusion", "Pneumonia"),
                       "Chest X-Ray with {c}.", "Chest X-Ray.", 512),
}


class BaseTrainer:
    def __init__(self, which: str, args, sd=None, load: Optional[Loader] = None, mesh: Optional[Mesh] = None):
        self.mesh = trainer_mesh(args) if mesh is None else mesh
        if which not in DOMAINS:
            raise ValueError(f"unknown domain {which!r}; expected one of {sorted(DOMAINS)}")
        self.which = which
        self.spec = DOMAINS[which]
        self.args = args
        self.device = resolve_device(args.device)
        self.load = load
        self._init_models(sd)

    # ------------------------------------------------------------------

    def _init_models(self, sd=None):
        args = self.args
        self.base_dir = None
        if sd is not None:
            self.unet, self.vae, self.clip = sd.unet, sd.vae, sd.clip
            self.tokenizer, self.schedule = sd.tokenizer, sd.schedule
            # the fused GroupNorm kernel is forward only: training keeps the
            # module path whatever the bundle's gate chose
            self.unet.config = dataclasses.replace(self.unet.config, fused_norm=False)
        elif os.path.isdir(args.base_name_or_path):
            self.base_dir = base = args.base_name_or_path
            p = load_pipeline_dir(base)
            self.unet = UNet2DCondition(p["unet"]["config"])
            load_state(self.unet, p["unet"]["state_dict"])
            self.vae = AutoencoderKL(p["vae"]["config"])
            load_state(self.vae, p["vae"]["state_dict"])
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
        ds.resolution = args.resolution or self.spec.resolution
        self.train_dataset = ds
        rows = None if self.mesh is None else host_local_batch_slice(args.train_batch_size, self.mesh)
        self.loader = BatchIterator(ds, args.train_batch_size, seed=args.seed, process_slice=rows)

    def _builder(self, optimizer) -> TrainStepBuilder:
        args = self.args
        return TrainStepBuilder(
            unet=self.unet, vae=self.vae, clip=self.clip, schedule=self.schedule, optimizer=optimizer,
            use_ema=args.use_ema, ema_max_decay=args.ema_decay, mixed_precision=args.mixed_precision != "no",
            lora_rank=args.lora_rank if args.lora else None, lora_seed=args.seed, mesh=self.mesh,
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
            lr *= args.gradient_accumulation_steps * args.train_batch_size * (1 if self.mesh is None else self.mesh.dp)
        self.optimizer = make_optimizer(
            make_lr_schedule(args.lr_scheduler, lr, args.lr_warmup_steps, args.max_train_steps),
            args.adam_beta1, args.adam_beta2, args.adam_weight_decay, args.adam_epsilon, args.max_grad_norm,
            args.gradient_accumulation_steps,
            accum_dtype=torch.bfloat16 if args.gradient_accumulation_dtype == "bf16" else None,
            use_8bit=args.use_8bit_adam,
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

    def _barrier(self, name: str) -> None:
        """Align the mesh's ranks; a trainer without a mesh runs alone even
        inside a process group (the sweep's export of a checkpoint)."""
        if self.mesh is not None:
            host_barrier(name)

    def _inner(self):
        opt = self.state.opt_state
        return opt.inner_state if isinstance(opt, AccumulateState) else opt

    def _state_dict(self) -> Optional[Dict[str, Any]]:
        """The whole state in the one-process layout, on rank 0; under fsdp
        every rank joins the gathers (each tensor brought to the host alone)
        and the others get None."""
        st, sh = self.state, self.builder.shards
        keep = is_writer(self.mesh)
        host = None if sh.fsdp == 1 else "cpu"
        shapes = [p.shape for p in st.params.values()]
        inner = self._inner()
        ema = None
        if st.ema_params is not None:
            ema = dict(zip(st.ema_params, sh.whole(list(st.ema_params.values()), shapes, host, keep)))
        saved = {"step": st.step, "params": st.params, "ema_params": ema}
        if isinstance(inner, Adam8bitState):
            saved["adam8bit"] = {"count": inner.count, **self._whole_8bit(inner, keep)}
        else:
            saved["adam"] = {"count": inner.count, "mu": sh.whole(inner.mu, shapes, host, keep),
                             "nu": sh.whole(inner.nu, shapes, host, keep)}
        opt = st.opt_state
        if isinstance(opt, AccumulateState):
            saved["accum"] = {"mini_step": opt.mini_step, "gradient_step": opt.gradient_step, "acc": opt.acc}
        return saved if keep else None

    def _whole_8bit(self, inner: Adam8bitState, keep: bool) -> Dict[str, List]:
        """8-bit Adam's int8 blocks and scales in the one-process group
        layout (``optim8bit.plan_groups`` of the whole tensors), each
        tensor's blocks gathered from the fsdp peers to the host (kept by
        ``keep`` alone); the state's own buffers at fsdp 1."""
        sh, names = self.builder.shards, ("mu_q", "mu_s", "nu_q", "nu_s")
        if sh.fsdp == 1:
            return {n: getattr(inner, n) for n in names}
        groups = optim8bit.plan_groups(sh.numels)
        whole = Adam8bitState(inner.count, groups, *(
            [torch.zeros((g.offsets[-1], width), dtype=dtype) for g in groups]
            for dtype, width in ((torch.int8, optim8bit._BLOCK), (torch.float32, 1)) * 2)) if keep else None
        for i in range(len(sh.numels)):
            for k, piece in enumerate(inner.tensor(i)):
                got = sh.gather(piece, i, blocks=True)
                if keep:
                    whole.tensor(i)[k].copy_(got)
        return {n: getattr(whole, n) for n in names} if keep else {}

    def _load_8bit(self, inner: Adam8bitState, saved: Dict[str, List]) -> None:
        """Copy this rank's blocks of each tensor out of a checkpoint's
        one-process group layout."""
        sh = self.builder.shards
        skeleton = Adam8bitState(saved["count"], optim8bit.plan_groups(sh.numels),
                                 *(saved[n] for n in ("mu_q", "mu_s", "nu_q", "nu_s")))
        for i in range(len(sh.numels)):
            rows = sh.rows(i, blocks=True)
            for dst, src in zip(inner.tensor(i), skeleton.tensor(i)):
                dst.copy_(src[rows])

    def save_checkpoint(self, step: int) -> None:
        """Write checkpoint-{step}/state.pt under a temporary name, then
        rename it into place; prune before and after, so the newest complete
        checkpoint survives a crash at any point. Rank 0 writes and prunes;
        every rank joins the gathers, then a barrier."""
        path = self._ckpt_dir(step)
        limit = self.args.checkpoints_total_limit
        writer = is_writer(self.mesh)
        if writer:
            self._prune_checkpoints(limit)
        done = os.path.isfile(join(path, "state.pt"))  # already saved at this step (end-of-training re-save)
        self._barrier("checkpoint_listed")  # every rank has looked before rank 0 writes
        if done:
            return
        saved = self._state_dict()
        if writer:
            tmp = f"{path}.tmp-{os.getpid()}"
            os.makedirs(tmp)
            torch.save(saved, join(tmp, "state.pt"))
            os.replace(tmp, path)
            logger.info("Saved state to %s", path)
            self._prune_checkpoints(limit)
        self._barrier("checkpoint")

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
        # on the host: each rank copies in its own pieces, whatever mesh wrote it
        saved = torch.load(join(path, "state.pt"), map_location="cpu", weights_only=True)
        st, sh = self.state, self.builder.shards

        def load_pieces(pieces, whole):
            for i, (piece, w) in enumerate(zip(pieces, whole)):
                piece.view(-1).copy_(w.reshape(-1)[sh.rows(i)])

        with torch.no_grad():
            for k, v in saved["params"].items():
                st.params[k].copy_(v)
            if st.ema_params is not None and saved["ema_params"] is not None:
                load_pieces(list(st.ema_params.values()), [saved["ema_params"][k] for k in st.ema_params])
            if not params_only:
                opt, inner = st.opt_state, self._inner()
                kind = "adam8bit" if isinstance(inner, Adam8bitState) else "adam"
                if kind not in saved:
                    raise ValueError(f"{path} holds no {kind} optimizer state (was it saved with another "
                                     "--use_8bit_adam setting?)")
                inner.count = saved[kind]["count"]
                if kind == "adam8bit":
                    self._load_8bit(inner, saved[kind])
                else:
                    load_pieces(inner.mu, saved[kind]["mu"])
                    load_pieces(inner.nu, saved[kind]["nu"])
                if isinstance(opt, AccumulateState) and "accum" in saved:
                    opt.mini_step = saved["accum"]["mini_step"]
                    opt.gradient_step = saved["accum"]["gradient_step"]
                    for acc, v in zip(opt.acc, saved["accum"]["acc"]):
                        acc.copy_(v)
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
    # previews (reference cars.py:235-255)
    # ------------------------------------------------------------------

    def _embed(self, prompts: List[str]) -> torch.Tensor:
        return self.clip(torch.from_numpy(self.tokenizer(prompts)).long().to(self.device))

    @torch.no_grad()
    def sample(self, categories=None, num_samples=None, steps=None, seed=42, guidance_scale=None,
               latents: Optional[torch.Tensor] = None) -> Dict[str, list]:
        """{category: PIL images}: ``num_samples`` DDIM samples (``steps``,
        classifier-free guidance against the domain's negative prompt) of
        the domain's preview prompt, on the EMA weights under --use_ema.
        The starting latents come from a generator seeded with ``seed``
        (one draw shared by every category), or ``latents``."""
        args = self.args
        categories = categories or self.spec.sample_categories
        num_samples = num_samples or args.num_samples_log
        steps = steps or args.num_inference_steps
        guidance_scale = guidance_scale if guidance_scale is not None else args.guidance_scale
        if latents is None:
            res = (args.resolution or self.spec.resolution) // 8
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            latents = torch.randn((num_samples, self.unet.config.in_channels, res, res), generator=g,
                                  device=self.device)

        logs = {}
        with self.builder.eval_unet(self.state, use_ema=args.use_ema) as eps_fn, self.builder._autocast(self.device):
            for c in categories:
                ctx = self._embed([self.spec.sample_prompt.format(c=c)] * num_samples)
                nctx = self._embed([self.spec.negative_prompt] * num_samples)
                z = sample_ddim(eps_fn, self.schedule, latents.to(self.device), ctx, nctx,
                                num_inference_steps=steps, guidance_scale=guidance_scale)
                logs[c] = tensor_to_images(self.vae.decode(z))
        return logs

    def save_previews(self) -> None:
        """--log_previews: rank 0 samples every category (``sample``) and
        writes the grids; under fsdp every rank joins the EMA's gather first
        (JAX samples on every process and writes on process 0: the same
        images)."""
        with self.builder.ema_whole(self.state):
            if is_writer(self.mesh):
                self.save_logs(self.sample())
        self._barrier("previews")

    def save_logs(self, logs: Dict[str, list]) -> None:
        """One grid a category, the samples side by side, under
        ``{output_dir}/plots/{global_step}/``."""
        plot_dir = join(self.args.output_dir, "plots", str(self.global_step))
        os.makedirs(plot_dir, exist_ok=True)
        for k, v in logs.items():
            hcat([p.convert("RGB") for p in v]).save(join(plot_dir, f"{k}.png"))

    # ------------------------------------------------------------------

    def end_training(self) -> str:
        """Export the pipeline (the EMA weights under --use_ema), written by
        rank 0; every rank joins the EMA's gather, then a barrier."""
        args = self.args
        export_dir = args.export_dir or join(args.output_dir, "export")
        with self.builder.ema_whole(self.state):
            if is_writer(self.mesh):
                save_pipeline_dir(
                    export_dir,
                    self.unet.config, self.builder.dense_params(self.state, use_ema=args.use_ema),
                    self.vae.config, self.vae.state_dict(),
                    self.clip.config, self.clip.state_dict(),
                    self.schedule,
                    tokenizer_src_dir=join(self.base_dir, "tokenizer") if self.base_dir else None,
                )
                logger.info("Exported pipeline to %s", export_dir)
        self._barrier("export")
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
        writer = is_writer(self.mesh)
        if writer:
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
        metrics_path = join(args.output_dir, args.logging_dir, "metrics.jsonl")
        with MetricsLogger(metrics_path) if writer else contextlib.nullcontext() as metrics:
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
                        mean_loss = float(torch.stack(losses).mean())  # the dp mean, alike on every rank
                        if writer:
                            logger.info("step %d loss %.4f", self.global_step, mean_loss)
                            metrics.log(self.global_step, train_loss=mean_loss, epoch=epoch,
                                        steps_per_sec=timer.steps_per_sec())
                        if args.log_previews:
                            self.save_previews()
                    if self.global_step >= args.max_train_steps:
                        done = True
                        break
                if done:
                    break
        if args.log_previews:
            self.save_previews()
        self.save_checkpoint(self.global_step)
        return self.end_training()
