"""One-command checkpoint verification in PyTorch (counterpart of
diffmining_tpu/utils/verify_checkpoint.py):

    python -m diffmining_tpu_torch verify_checkpoint <pipeline_dir> \\
        [--torch_oracle] [--probes probes.npz] [--theirs ref_typicality_dir] \\
        [--which cars --dataset data_dir] [--sweep_images 2] [--n_samples 100] \\
        [--device cuda|cpu]

Stages (each prints PASS, FAIL or SKIP; exit code 1 on any FAIL):
  1. convert    — load the diffusers-layout dir through load_pipeline_dir.
  2. structure  — every loaded state dict must match its module's
                  ``state_dict()`` exactly, in keys and in shapes (the
                  modules are built on the meta device: no weights, no
                  compute). Catches every rename or transpose drift.
  3. forward    — a small deterministic float32 forward of CLIP, the VAE
                  encoder and the UNet on ``--device``; finiteness.
  4. probes     — optional activation parity against torch recordings
                  (NCHW float32 npz: image, prompt, t, text_hidden, vae_mean,
                  unet_eps). Reports max|Δ| and pearson per module.
     torch_oracle — optional: the checkpoint's raw UNet tensors in the
                  hand transcription of utils/torch_oracle.py against the
                  port's UNet; the text tower against transformers where it
                  is installed (SKIP where it is not).
  5. fidelity   — optional 2-image typicality mini-sweep compared against a
                  reference artifact tree (mean per-pixel map correlation).
  6. cluster_rank — with --theirs: the cluster rank correlation of the full
                  mining chain (patch union → DIFT → k-means → median rank).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from os.path import join
from typing import Dict, Tuple

import numpy as np
import torch

from diffmining_tpu_torch.utils.fidelity import pearson, spearman

PROBE_KEYS = ("text_hidden", "vae_mean", "unet_eps")


class _SkipStage(Exception):
    """A verify stage that cannot run (a missing optional oracle dependency)
    is skipped rather than failed."""


def _shapes(state: Dict[str, torch.Tensor]) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in state.items() if not k.endswith("position_ids")}


def check_structure(name: str, state: Dict[str, torch.Tensor], module: torch.nn.Module) -> bool:
    """The loaded state dict against the module's own, keys and shapes (a
    transformers ``position_ids`` buffer, which is derived, is ignored)."""
    got, want = _shapes(state), _shapes(module.state_dict())
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shape_bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    ok = not (missing or extra or shape_bad)
    print(f"[structure:{name}] {'PASS' if ok else 'FAIL'} ({len(want)} params)")
    for k in missing[:8]:
        print(f"    missing from checkpoint: {k} {want[k]}")
    for k in extra[:8]:
        print(f"    unexpected in checkpoint: {k} {got[k]}")
    for k in shape_bad[:8]:
        print(f"    shape mismatch {k}: ckpt {got[k]} vs model {want[k]}")
    return ok


def _on_meta(cls, config):
    with torch.device("meta"):
        return cls(config)


def _loaded(cls, config, state, device):
    """A module of ``cls`` holding exactly ``state`` on ``device``, float32."""
    from diffmining_tpu_torch.utils.weights import load_state

    module = _on_meta(cls, config).to_empty(device=device)
    load_state(module, state)
    return module.float().eval().requires_grad_(False)


def cluster_rank_correlation(
    pipeline_dir: str,
    dataset: str,
    which: str,
    ours_tree: str,
    theirs_tree: str,
    num_clusters: int = 32,
    k_per_image: int = 5,
    patch: int = 64,
    feature_which: str = "dift-161",
    cache_path: str = None,
    sd=None,
    device="cuda",
) -> Dict[str, float]:
    """The cluster rank correlation of the full mining chain between two
    typicality artifact trees: both trees' top-k patches are mined with the
    same code, their union is DIFT-featurised once and k-means-clustered
    jointly, each cluster is median-ranked under each tree's scores, and the
    per-category number is the Spearman correlation of the two cluster score
    vectors (1.0 for identical maps)."""
    import pandas as pd

    from diffmining_tpu_torch.ops.kmeans import KMeans
    from diffmining_tpu_torch.ops.pool import top_patches
    from diffmining_tpu_torch.typicality.cluster import PATCH_COLUMNS, Cluster

    cache = cache_path or join(ours_tree, "_rank_cache")
    dtype = sd.dtype if sd is not None else torch.bfloat16
    ours = Cluster(which, ours_tree, dataset, cache, model_path=pipeline_dir, kx=patch, ky=patch,
                   cache_features=False, dift_sd=sd, device=device, dtype=dtype)
    theirs = Cluster(which, theirs_tree, dataset, join(cache, "theirs"), kx=patch, ky=patch,
                     cache_features=False, device=device, dtype=dtype)
    per_cat: Dict[str, float] = {}
    for c in sorted(ours.categories()):
        seeds = [p for p in ours.get_seeds(ours.D[c], c) if theirs.D[c].exists(p)]
        if not seeds:
            continue
        maps_o, maps_t = {}, {}
        union: Dict[Tuple[str, Tuple[int, int, int, int]], None] = {}
        for path in seeds:
            maps_o[path] = ours.load_typicality(ours.D[c], path)
            maps_t[path] = theirs.load_typicality(theirs.D[c], path)
            for m in (maps_o[path], maps_t[path]):
                boxes, _ = top_patches(m, patch, patch, k_per_image)
                for b in boxes:
                    union.setdefault((path, tuple(int(v) for v in b)))
        patches = list(union)
        if len(patches) < 4:
            continue
        nc = min(num_clusters, max(2, len(patches) // 2))
        # the df_D score convention: the pooled map at the patch's top-left corner
        rows = [(path, x0, y0, x1, y1, float(maps_o[path][x0, y0]), "real") for path, (x0, y0, x1, y1) in patches]
        df = pd.DataFrame(rows, columns=PATCH_COLUMNS)
        X, _ids, _pils, _ds, _paths = ours.compute_embeddings(df, c=c, to_add_border=False,
                                                              feature_which=feature_which)
        km = KMeans(n_clusters=nc, random_state=10, device=device).fit(np.stack(X, axis=0))
        members: Dict[int, list] = {}
        for i, lab in enumerate(km.labels_):
            members.setdefault(int(lab), []).append(i)
        score_o, score_t = [], []
        for k in sorted(members):
            idx = members[k]
            score_o.append(float(np.median([maps_o[patches[i][0]][patches[i][1][0], patches[i][1][1]] for i in idx])))
            score_t.append(float(np.median([maps_t[patches[i][0]][patches[i][1][0], patches[i][1][1]] for i in idx])))
        per_cat[c] = spearman(np.asarray(score_o, np.float64), np.asarray(score_t, np.float64))
    return per_cat


def _torch_oracle_stages(args, p, unet, clip, device) -> bool:
    """The UNet against the hand transcription on the checkpoint's raw
    tensors; the text tower against transformers where it is installed."""
    from diffmining_tpu_torch.utils.torch_oracle import UNet2DConditionRef
    from diffmining_tpu_torch.utils.weights import read_safetensors_dir

    ok = True
    try:
        cfg = p["unet"]["config"]
        tref = UNet2DConditionRef(
            in_channels=cfg.in_channels, out_channels=cfg.out_channels, block_out_channels=cfg.block_out_channels,
            layers_per_block=cfg.layers_per_block, cross_attention_dim=cfg.cross_attention_dim,
            num_attention_heads=cfg.num_attention_heads, down_block_has_attn=cfg.down_block_has_attn,
            norm_num_groups=cfg.norm_num_groups, transformer_layers=cfg.transformer_layers,
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        ).eval()
        raw = read_safetensors_dir(join(args.pipeline_dir, "unet"))
        missing, unexpected = tref.load_state_dict(
            {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in raw.items()}, strict=False)
        if missing:
            print(f"[torch_oracle] FAIL ({len(missing)} checkpoint keys missing, e.g. {missing[:3]})")
            ok = False
        else:
            if unexpected:
                print(f"[torch_oracle] note: {len(unexpected)} unconsumed checkpoint keys, e.g. {unexpected[:3]}")
            rng_np = np.random.RandomState(0)
            x = rng_np.randn(1, cfg.in_channels, 16, 16).astype(np.float32)
            ctx = rng_np.randn(1, 77, cfg.cross_attention_dim).astype(np.float32)
            t = torch.tensor([261])
            with torch.no_grad():
                tref = tref.to(device)
                want = tref(torch.from_numpy(x).to(device), t.to(device), torch.from_numpy(ctx).to(device))
                got = unet(torch.from_numpy(x).to(device), t.to(device), torch.from_numpy(ctx).to(device))
            want, got = want.float().cpu().numpy(), got.float().cpu().numpy()
            d = float(np.abs(got - want).max())
            r = pearson(got, want)
            good = d < args.probe_tol and r > 0.999
            print(f"[torch_oracle] {'PASS' if good else 'FAIL'} max|Δ|={d:.2e} pearson={r:.6f}")
            ok &= good
    except Exception as e:
        print(f"[torch_oracle] FAIL ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        ok = False

    # the text tower's oracle is transformers (what the reference imports);
    # where it is not installed there is nothing to compare against: skip
    try:
        import transformers
    except ImportError:
        transformers = None
        print("[torch_oracle:text] SKIP (transformers not installed)")
    try:
        if transformers is None:
            raise _SkipStage
        tc = p["text_encoder"]["config"]
        hf = transformers.CLIPTextModel(transformers.CLIPTextConfig(
            vocab_size=tc.vocab_size, hidden_size=tc.hidden_size, intermediate_size=tc.intermediate_size,
            num_hidden_layers=tc.num_layers, num_attention_heads=tc.num_heads, max_position_embeddings=77,
            hidden_act=tc.hidden_act)).eval()
        raw_t = read_safetensors_dir(join(args.pipeline_dir, "text_encoder"))
        missing, _unexp = hf.load_state_dict(
            {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in raw_t.items()}, strict=False)
        missing = [m for m in missing if not m.endswith("position_ids")]
        if missing:
            print(f"[torch_oracle:text] FAIL ({len(missing)} keys missing, e.g. {missing[:3]})")
            ok = False
        else:
            ids_np = np.random.RandomState(1).randint(0, tc.vocab_size, (2, 77))
            with torch.no_grad():
                want_h = hf(torch.from_numpy(ids_np)).last_hidden_state.numpy()
                got_h = clip(torch.from_numpy(ids_np).to(device)).float().cpu().numpy()
            d = float(np.abs(got_h - want_h).max())
            r = pearson(got_h, want_h)
            good = d < args.probe_tol and r > 0.999
            print(f"[torch_oracle:text] {'PASS' if good else 'FAIL'} max|Δ|={d:.2e} pearson={r:.6f}")
            ok &= good
    except _SkipStage:
        pass
    except Exception as e:
        print(f"[torch_oracle:text] FAIL ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        ok = False
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="verify a converted SD pipeline checkpoint")
    ap.add_argument("pipeline_dir")
    ap.add_argument("--probes", default=None, help="npz of torch activations (NCHW float32)")
    ap.add_argument("--torch_oracle", action="store_true",
                    help="run the checkpoint's own weights through the hand transcription "
                         "(utils/torch_oracle.py) and compare one UNet forward against the port's UNet")
    ap.add_argument("--probe_tol", type=float, default=5e-2, help="max|Δ| gate for probe parity")
    ap.add_argument("--theirs", default=None, help="reference typicality artifact tree to correlate against")
    ap.add_argument("--which", default="cars")
    ap.add_argument("--dataset", default=None, help="dataset dir for the mini-sweep")
    ap.add_argument("--sweep_images", type=int, default=2)
    ap.add_argument("--n_samples", type=int, default=100)
    ap.add_argument("--t_min", type=float, default=0.1)
    ap.add_argument("--t_max", type=float, default=0.7)
    ap.add_argument("--rank_images", type=int, default=16,
                    help="images to sweep for the cluster-rank stage (>= sweep_images)")
    ap.add_argument("--rank_clusters", type=int, default=32)
    ap.add_argument("--rank_patch", type=int, default=64, help="patch size (reference: 64)")
    ap.add_argument("--rank_feature", default="dift-161")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from diffmining_tpu_torch.models.clip import CLIPTextModel
    from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
    from diffmining_tpu_torch.models.unet import UNet2DCondition
    from diffmining_tpu_torch.models.vae import AutoencoderKL
    from diffmining_tpu_torch.utils.device import resolve_device
    from diffmining_tpu_torch.utils.weights import load_pipeline_dir

    device = resolve_device(args.device)
    ok = True

    # 1. convert ------------------------------------------------------------
    p = load_pipeline_dir(args.pipeline_dir)
    print(f"[convert] PASS (unet/vae/text_encoder/scheduler loaded from {args.pipeline_dir})")
    classes = {"unet": UNet2DCondition, "vae": AutoencoderKL, "text_encoder": CLIPTextModel}

    # 2. structure -----------------------------------------------------------
    for name, cls in classes.items():
        ok &= check_structure(name, p[name]["state_dict"], _on_meta(cls, p[name]["config"]))

    # 3. forward -------------------------------------------------------------
    tok_dir = p["tokenizer_dir"]
    if os.path.isfile(join(tok_dir, "vocab.json")):
        tokenizer = CLIPTokenizer.from_pretrained_dir(tok_dir)
    else:
        tokenizer = tiny_tokenizer(p["text_encoder"]["config"].vocab_size)
    unet = vae = clip = None
    try:
        unet, vae, clip = (_loaded(cls, p[name]["config"], p[name]["state_dict"], device)
                           for name, cls in classes.items())
        ucfg, vcfg = p["unet"]["config"], p["vae"]["config"]
        f = 2 ** (len(vcfg.block_out_channels) - 1)
        with torch.no_grad():
            hidden = clip(torch.from_numpy(tokenizer([""])).long().to(device))
            lat0 = torch.zeros(1, ucfg.in_channels, 8, 8, device=device)
            eps = unet(lat0, torch.tensor([261], device=device), hidden)
            img0 = torch.zeros(1, vcfg.in_channels, 8 * f, 8 * f, device=device)
            mean, logvar = vae.encode(img0)
        fin = all(bool(torch.isfinite(x).all()) for x in (hidden, eps, mean, logvar))
        print(f"[forward] {'PASS' if fin else 'FAIL'} (clip/unet/vae finite; eps std {float(eps.std()):.4f})")
        ok &= fin
    except Exception as e:  # a structure failure usually implies this one
        print(f"[forward] FAIL ({type(e).__name__}: {str(e).splitlines()[0][:120]})")
        ok = False
        unet = None
        if args.probes:
            print("[probe:*] SKIP (forward failed)")
            args.probes = None

    # 4a. torch oracle --------------------------------------------------------
    if args.torch_oracle:
        if unet is None:
            print("[torch_oracle] FAIL (the checkpoint does not load into the port's modules)")
            ok = False
        else:
            ok &= _torch_oracle_stages(args, p, unet, clip, device)

    # 4. probes --------------------------------------------------------------
    if args.probes:
        from diffmining_tpu_torch.diffusion.schedule import add_noise

        z = np.load(args.probes, allow_pickle=True)
        image = torch.from_numpy(np.asarray(z["image"], np.float32)).permute(2, 0, 1)[None].to(device)
        t = torch.tensor([int(z["t"])], device=device)
        with torch.no_grad():
            hidden = clip(torch.from_numpy(tokenizer([str(z["prompt"])])).long().to(device))
            mean = vae.encode(image)[0]
            # deterministic latent: the posterior mean × sf, zero noise at t
            lat = mean * p["vae"]["config"].scaling_factor
            noisy = add_noise(p["schedule"].to(device), lat, torch.zeros_like(lat), t)
            eps = unet(noisy, t, hidden)
        got_all = {"text_hidden": hidden[0], "vae_mean": mean[0], "unet_eps": eps[0]}
        for key in PROBE_KEYS:
            got = got_all[key].float().cpu().numpy()
            want = np.asarray(z[key], np.float32)
            d = float(np.abs(got - want).max())
            r = pearson(got, want)
            good = d < args.probe_tol and r > 0.999
            print(f"[probe:{key}] {'PASS' if good else 'FAIL'} max|Δ|={d:.2e} pearson={r:.6f}")
            ok &= good
    del unet, vae, clip

    # 5. fidelity mini-sweep ---------------------------------------------------
    if args.theirs:
        if not args.dataset:
            raise SystemExit("--theirs requires --dataset/--which for the mini-sweep")
        from diffmining_tpu_torch.typicality.compute import Typicality
        from diffmining_tpu_torch.utils.fidelity import compare_typicality_dirs

        with tempfile.TemporaryDirectory() as tmp:
            # the sweep's dtype: on the card the JAX Typicality's default, bf16
            # (diffmining_tpu/typicality/compute.py:451); float32 on the CPU
            dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
            typ = Typicality(args.which, args.pipeline_dir, args.dataset, tmp, N=args.n_samples, t_min=args.t_min,
                             t_max=args.t_max, dtype=dtype, device=device)
            n_target = max(args.sweep_images, args.rank_images)
            n = 0
            for c in typ.categories():
                if n >= n_target:
                    break
                seeds = typ.get_seeds_(c)[: n_target - n]
                # prefer images the reference tree has, so correlations exist
                ref_cat = join(args.theirs, c)
                if os.path.isdir(ref_cat):
                    have = {os.path.splitext(f)[0] for f in os.listdir(ref_cat)}
                    preferred = [s for s in typ.get_seeds_(c) if os.path.splitext(os.path.basename(s))[0] in have]
                    seeds = (preferred or seeds)[: n_target - n]
                typ.D[c].compute_batch([(s, c) for s in seeds])
                n += len(seeds)
            res = compare_typicality_dirs(tmp, args.theirs)
            mean = res.get("__mean__", 0.0)
            good = mean > 0.95 and len(res) > 1
            print(f"[fidelity] {'PASS' if good else 'FAIL'} mean map correlation {mean:.4f} over "
                  f"{max(len(res) - 1, 0)} image(s)")
            ok &= good

            # 6. cluster-rank over the full mining chain
            if args.rank_images > 0:
                per_cat = cluster_rank_correlation(
                    args.pipeline_dir, args.dataset, args.which, ours_tree=tmp, theirs_tree=args.theirs,
                    num_clusters=args.rank_clusters, patch=args.rank_patch, feature_which=args.rank_feature,
                    cache_path=join(tmp, "_rank_cache"), sd=typ.sd, device=device)
                if per_cat:
                    mean_r = float(np.mean(list(per_cat.values())))
                    good = mean_r > 0.95
                    detail = " ".join(f"{c}={v:.3f}" for c, v in sorted(per_cat.items()))
                    print(f"[cluster_rank] {'PASS' if good else 'FAIL'} mean spearman {mean_r:.4f} ({detail})")
                    ok &= good
                else:
                    print("[cluster_rank] FAIL (no category had >=4 shared patches)")
                    ok = False

    print(f"verify_checkpoint: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
