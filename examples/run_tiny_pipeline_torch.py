"""End-to-end demo of the full product line on synthetic datasets, through
the PyTorch port (``diffmining_tpu_torch``).

The same nine stages as ``examples/run_tiny_pipeline.py``, in the same order
and with the same arguments: finetune -> export -> typicality sweep -> patch
mining/clustering -> figures/HTML, then the application line (PnP
translation -> parallel-dataset typicality + cross-country clustering) and
both baselines (Doersch-2012 HOG/SVM, CLIP patch ranking), on the tiny
random stack:

    python examples/run_tiny_pipeline_torch.py OUT_DIR                # on the GPU
    python examples/run_tiny_pipeline_torch.py OUT_DIR --device cpu

At 32-128 px no attention reaches the kernels' gate (L >= 1024), so on the
GPU this runs the whole line on CUDA tensors in one process and launches no
hand-written kernel. The tiny stack's weights come from seeded
``torch.Generator`` draws, not JAX's threefry, so the draw-decided parts of
the output (patch boxes, cluster ranks and sizes) differ from the JAX
example's; the tree of files does not.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from os.path import join

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image

DECADES = ["1930", "1990"]


def make_dataset(root: str) -> str:
    rng = np.random.RandomState(0)
    data = join(root, "ftt", "train")
    for dec, base in [("1930", 30), ("1990", 170)]:
        os.makedirs(join(data, dec), exist_ok=True)
        for i in range(4):
            arr = (rng.randint(0, 80, (32, 32, 3)) + base).astype(np.uint8)
            Image.fromarray(arr).save(join(data, dec, f"img_{dec}_{i}.jpg"))
    return join(root, "ftt")


def main(root: str, device: str = "cuda") -> None:
    import torch

    from diffmining_tpu_torch.finetuning.args import parse_args
    from diffmining_tpu_torch.finetuning.base import BaseTrainer
    from diffmining_tpu_torch.typicality.cluster import Cluster
    from diffmining_tpu_torch.typicality.compute import SD, Typicality
    from diffmining_tpu_torch.typicality.make_html import generate_html
    from diffmining_tpu_torch.utils.export import save_pipeline_dir

    data_root = make_dataset(root)

    # 0. a "pretrained" tiny SD pipeline (random init stands in for SD-v1.5)
    sd0 = SD.init_tiny("ftt", DECADES, device=device)
    base_dir = join(root, "models", "base")
    save_pipeline_dir(
        base_dir, sd0.unet.config, sd0.unet.state_dict(), sd0.vae.config, sd0.vae.state_dict(),
        sd0.clip.config, sd0.clip.state_dict(), sd0.schedule,
    )
    del sd0
    print("[0] base pipeline:", base_dir)

    # 1. finetune for a few steps and export
    args = parse_args([
        "--base_name_or_path", base_dir,
        "--data_path", data_root,
        "--output_dir", join(root, "models", "ft"),
        "--train_batch_size", "2", "--max_train_steps", "4",
        "--resolution", "32", "--mixed_precision", "no", "--use_ema",
        "--device", device,
    ])
    export_dir = BaseTrainer("ftt", args).train()
    print("[1] finetuned export:", export_dir)

    # 2. typicality sweep (submission work queue -> batched sweeps -> .npy)
    typ_path = join(root, "typicality")
    sub_path = join(root, "submission")
    typ = Typicality("ftt", export_dir, join(data_root, "train"), typ_path,
                     t_min=0.1, t_max=0.7, N=8, batch_images=4, device=device)
    typ.make_submission(join(data_root, "train"), sub_path, sub_split=1)
    typ.compute_submission(join(sub_path, "0.txt"))
    del typ
    print("[2] typicality artifacts:", os.listdir(typ_path))

    # 3. mine + cluster + figures
    cache = join(root, "cache")
    figs = join(root, "figures", "ft", "0.1-0.7")
    cl = Cluster("ftt", typ_path, join(data_root, "train"), cache,
                 model_path=export_dir, kx=8, ky=8, device=device)
    cl.clustering(feature_which="dift-161", k_per_image=3, k=12, num_clusters=2)
    cl.plot_top_k(k_per_image=3, k=6, overlays=True)  # typicality-as-alpha composites
    cl.make_figure(figs, min_im=2, hard_limit=4)
    cl.make_topk_figure(figs)
    del cl
    print("[3] clusters + figures:", os.listdir(join(figs, "clusters")))

    # 4. HTML report
    html = generate_html(join(root, "figures"), join(root, "html"))
    print("[4] report:", html)

    # 5. Doersch-2012 baseline (HOG+SVM detectors need 64x64 patches, so a
    #    second 128px mini-dataset)
    from diffmining_tpu_torch.baselines.doersch import Doersch

    rng = np.random.RandomState(0)
    ddata = join(root, "doersch_data")
    for dec, base in [("1930", 40), ("1990", 200)]:
        os.makedirs(join(ddata, dec), exist_ok=True)
        for i in range(3):
            arr = (rng.randint(0, 55, (128, 128, 3)) + base).astype(np.uint8)
            Image.fromarray(arr).save(join(ddata, dec, f"d{dec}_{i}.jpg"))
    do = Doersch(join(root, "doersch"), "ftt", ddata, how_many=6, threshold=50, device=device)
    do.get_top("1930", top_k=3, top_elem=3)
    print("[5] doersch detectors:",
          [f for f in os.listdir(join(root, "doersch", "ftt", "1930")) if f.startswith("top_")])

    # 6. PnP translation (geo application; batched same-shape sources)
    from diffmining_tpu_torch.applications.pnp import Generator

    countries = ["France", "Japan"]
    sdg = SD.init_tiny("geo", countries, device=device)
    gbase = join(root, "geo_base")
    for c in countries:
        os.makedirs(join(gbase, c), exist_ok=True)
        for sid in ("a1", "b2"):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3)).astype(np.uint8)).save(
                join(gbase, c, f"{c}__{sid}_0.jpg")
            )
    trans = join(root, "translated")
    for c in countries:
        paths = [join(gbase, c, f) for f in sorted(os.listdir(join(gbase, c)))]
        g = Generator(sdg, paths, inversion_steps=4, n_timesteps=2)
        g.plotum(join(trans, c), countries, batch_size=2)
    print("[6] pnp translations:", sorted(os.listdir(join(trans, "France"))))

    # 7. parallel-dataset typicality + cross-country clustering
    from diffmining_tpu_torch.applications.parallel import ParallelCluster, ParallelTypicality

    ptyp = join(root, "ptypicality")
    pt = ParallelTypicality(None, trans, ptyp, sd=sdg, N=4, device=device)
    for c in countries:
        pt.D[c].compute_batch([(p, c) for p in pt.get_seeds_(c)])
    pcl = ParallelCluster(ptyp, trans, join(root, "pcache"), sd=sdg, dift_sd=sdg, kx=8, ky=8, device=device)
    pclusters = pcl.clustering(feature_which="dift-161", k_per_image=2, k=8,
                               num_clusters=2, num_components=2)
    pfigs = join(root, "figures_parallel")
    pcl.make_figure(pfigs, k=8, num_clusters=2, min_im=1, feature_which="dift-161")
    print("[7] parallel clusters:", [len(members) for members, _d in pclusters])

    # 8. CLIP patch-ranking baseline over the translated tree (tiny towers,
    #    flax's default init drawn from a seeded generator)
    from diffmining_tpu_torch.baselines.clipmining import CLIPRankCluster, random_vision_tower
    from diffmining_tpu_torch.models.clip import CLIPTextModelWithProjection, TINY_CLIP_TEXT, TINY_CLIP_VISION
    from diffmining_tpu_torch.models.tokenizer import tiny_tokenizer
    from diffmining_tpu_torch.typicality.compute import init_random_

    gen = torch.Generator().manual_seed(0)
    vision = random_vision_tower(TINY_CLIP_VISION, gen)
    text = CLIPTextModelWithProjection(TINY_CLIP_TEXT, projection_dim=16)
    init_random_(text, gen)
    rc = CLIPRankCluster(
        trans, join(root, "clip_cache"), "diff", vision=vision, text=text,
        tokenizer=tiny_tokenizer(TINY_CLIP_TEXT.vocab_size), crop=32, batch_images=2, device=device,
    )
    rc.clustering(k_per_image=2, k=8, num_clusters=2, hard_limit=4, kx=8, ky=8)
    print("[8] clip-baseline figures:",
          sorted(os.listdir(join(root, "clip_cache", "diff", "figures"))))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="the whole product line on the tiny random stack, through the port")
    p.add_argument("root", nargs="?", default=join(tempfile.gettempdir(), "diffmine-demo-torch"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    main(a.root, a.device)
