"""X-ray disease localization: typicality maps against ground-truth boxes
(counterpart of diffmining_tpu/applications/xray.py; reference
diffmining/applications/xray/compute.py).

  * diseases: the 8 NIH ChestX-ray14 classes (compute.py:423);
  * per image: N (eps, t) draws over the FULL t range, conditions
    [disease, ""]; the pixel map is mean[L_null - L_disease] upsampled to the
    image (compute.py:210-218), optionally Gaussian-blurred (sigma 32,
    kernel 127);
  * ground-truth boxes from BBox_List_2017.csv with coordinates halved
    (compute.py:186);
  * metrics: mean typicality inside the box and AUC-PR over 1000
    log-spaced thresholds 2·10^-linspace(2,7) by trapezoid integration
    (compute.py:263-284) -> report.json / auc.json;
  * compare_json_files prints the pre/post-finetune table
    (compute.py:350-389).

Same-shape images go through the sweep engine in groups of
``batch_images`` (1024px: level-0 self-attention at L = 16384, the
multi-block no-max kernel). Pixel maps are cached as
``{name}_loss_pixel.npy``, as the reference caches them. The random draws
follow the sweep's contract: ``draws(uid, latent_shape) -> (posterior eps,
noise, t)``, default ``SeededDraws``; tests pass the JAX package's.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import random
from collections import defaultdict
from os.path import join
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from diffmining_tpu_torch.ops import pool
from diffmining_tpu_torch.typicality.compute import DTYPES, SD, sweep_images
from diffmining_tpu_torch.typicality.engine import SeededDraws, TypicalityEngine
from diffmining_tpu_torch.utils.artifacts import atomic_save_npy
from diffmining_tpu_torch.utils.images import array_from_uint8, image_uid

DISEASES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltrate",
    "Mass", "Nodule", "Pneumonia", "Pneumothorax",
]

Box = Tuple[int, int, int, int]  # (x1, y1, x2, y2) in image coordinates


def xray_prompt(c: str) -> str:
    """reference compute.py:55: 'Chest X-Ray with {c}.' / base 'Chest X-Ray'."""
    return f"Chest X-Ray with {c}." if len(c) else "Chest X-Ray"


def gaussian_blur(dm: np.ndarray, sigma: float = 32.0, ksize: int = 127) -> np.ndarray:
    """Separable Gaussian blur of a host map (the reference's torchvision
    GaussianBlur(127, 32), xray/compute.py:165,207) through
    ``ops.pool.gaussian_blur``; the sweep blurs its maps on their device."""
    out = pool.gaussian_blur(torch.from_numpy(np.ascontiguousarray(dm)), float(sigma), int(ksize))
    return out.numpy().astype(dm.dtype)


def gaussian_blur_np(dm: np.ndarray, sigma: float = 32.0, ksize: int = 127) -> np.ndarray:
    """Host reference implementation (the tests' oracle)."""
    r = ksize // 2
    k = pool.gauss_kernel_1d(sigma, ksize)
    pad = np.pad(dm, ((r, r), (r, r)), mode="reflect")
    out = np.apply_along_axis(lambda row: np.convolve(row, k, mode="valid"), 1, pad)
    out = np.apply_along_axis(lambda col: np.convolve(col, k, mode="valid"), 0, out)
    return out.astype(dm.dtype)


def mean_typicality(bbox: Box, dm: np.ndarray) -> float:
    """bbox in (x1, y1, x2, y2) image coords; dm indexed [y, x]
    (reference compute.py:263-264)."""
    x1, y1, x2, y2 = bbox
    return float(dm[y1:y2, x1:x2].mean())


def aucpr(bbox: Box, dm: np.ndarray) -> float:
    """AUC-PR over 1000 log-spaced thresholds (reference compute.py:266-284)."""
    thresholds = 2 * 10 ** (-np.linspace(2, 7, 1000))
    x = np.zeros_like(dm)
    x1, y1, x2, y2 = bbox
    x[y1:y2, x1:x2] = 1
    dm_f, x_f = dm.flatten(), x.flatten()
    tp = np.sum(dm_f[x_f == 1] > thresholds[:, None], axis=1)
    fp = np.sum(dm_f[x_f == 0] > thresholds[:, None], axis=1)
    denom = tp + fp
    precision = np.where(denom > 0, tp / np.maximum(denom, 1), 0)
    recall = tp / max(x.sum(), 1)
    return float(np.trapezoid(precision, recall))


def load_paths(gt_path: str, diseases: Sequence[str], seed: int = 42) -> Dict[str, List[Tuple[str, Box]]]:
    """metadata.csv + BBox_List_2017.csv (boxes halved: the reference's
    image copy is at half the CSV's resolution), grouped per disease, each
    list in a seeded order by the number of findings (reference
    compute.py:170-205)."""
    labels: Dict[str, str] = {}
    with open(join(gt_path, "metadata.csv")) as f:
        for row in csv.DictReader(f):
            name = row.get("Image Index") or row.get("fname")
            labels[name] = row.get("Finding Labels") or row.get("label", "")

    bbox: Dict[Tuple[str, str], Box] = {}
    with open(join(gt_path, "BBox_List_2017.csv")) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            if len(row) < 6 or not row[0]:
                continue
            fname, label = row[0], row[1]
            x, y, w, h = (float(v) for v in row[2:6])
            bbox[(fname, label)] = tuple(int(v / 2) for v in (x, y, x + w, y + h))

    parent: Dict[str, List[Tuple[str, Box]]] = defaultdict(list)
    tmp: Dict[str, List] = defaultdict(list)
    for (fname, label), bb in bbox.items():
        if fname not in labels:
            continue
        all_diseases = labels[fname].split("|")
        for disease in diseases:
            if disease == label and disease in all_diseases:
                tmp[disease].append((join(gt_path, "images", fname), all_diseases, bb))
    rng = random.Random(seed)
    for k, v in tmp.items():
        v = sorted(v, key=lambda x: (len(x[1]), rng.random()))
        parent[k] = [(a, c) for a, _, c in v]
    return parent


class XRayTypicality:
    """Pixel maps and box metrics of every disease's images. ``chunk=3``
    with ``batch_images=4`` is the JAX package's measured 1024px grouping
    (UNet batch 24); the engine snaps ``chunk`` to the largest divisor of
    ``N`` (2 at N=100)."""

    def __init__(self, sd: SD, gt_path: str, output_path: str, diseases: Sequence[str] = DISEASES,
                 seed: int = 42, N: int = 100, blur: bool = False, chunk: int = 3,
                 draws: Optional[Callable] = None):
        self.sd = sd
        self.output_path = output_path
        self.diseases = sorted(diseases)
        self.seed = seed
        self.N = N
        self.blur = blur
        self.parent = load_paths(gt_path, self.diseases, seed)
        self.engine = TypicalityEngine(unet=sd.unet, schedule=sd.schedule, n_samples=N, chunk=chunk)
        self.draws = draws or SeededDraws(seed, N, 0.0, 1.0, sd.schedule.num_train_timesteps, sd.device)
        # every prompt embedded once: "no finding", the null prompt, the diseases
        names = ["no finding", ""] + self.diseases
        ids = torch.from_numpy(sd.tokenizer([xray_prompt(c) for c in names])).long().to(sd.device)
        with torch.inference_mode():
            cf = sd.clip(ids).float()
        self.embeds = {c: cf[i] for i, c in enumerate(names)}

    def pixel_maps(self, disease: str, paths: Sequence[str]) -> List[np.ndarray]:
        """float32 pixel maps of SAME-SHAPE images through one batched sweep
        (the reference loops one image at a time, xray/compute.py:296-311).
        Each image's draws come from its own uid, so a map does not depend
        on its group."""
        imgs = [Image.open(p).convert("RGB") for p in paths]
        images = torch.from_numpy(np.stack([array_from_uint8(np.asarray(im)) for im in imgs])).permute(0, 3, 1, 2)
        ctx = torch.stack([self.embeds[disease], self.embeds[""]])
        losses = sweep_images(self.sd, self.engine, self.draws, images, [image_uid(p) for p in paths], ctx)
        out = []
        for b, im in enumerate(imgs):
            w, h = im.size
            dm = pool.pixel_typicality_map(losses[b], h, w)
            if self.blur:
                dm = pool.gaussian_blur(dm)
            out.append(dm.cpu().numpy())
        return out

    def pixel_map(self, disease: str, path: str) -> np.ndarray:
        return self.pixel_maps(disease, [path])[0]

    def main(self, batch_images: int = 4) -> Tuple[Dict, Dict]:
        report, auc = {}, {}
        for disease in self.diseases:
            report[disease], auc[disease] = {}, {}
            typ_dir = join(self.output_path, disease, "typicality")
            os.makedirs(typ_dir, exist_ok=True)

            def cache_path(fpath):
                name = os.path.splitext(os.path.split(fpath)[-1])[0]
                return join(typ_dir, f"{name}_loss_pixel.npy")

            # the uncached images, by shape, through one sweep per group
            pending: Dict[Tuple[int, int], List[str]] = defaultdict(list)
            for fpath, _bbox in self.parent[disease]:
                if not os.path.isfile(cache_path(fpath)):
                    with Image.open(fpath) as im:
                        pending[im.size].append(fpath)
            for group in pending.values():
                for start in range(0, len(group), batch_images):
                    chunk = group[start:start + batch_images]
                    # a partial group repeats its last path: every sweep runs
                    # one batch size, and maps do not depend on the grouping
                    padded = chunk + [chunk[-1]] * (batch_images - len(chunk))
                    for fpath, dm in zip(chunk, self.pixel_maps(disease, padded)):
                        atomic_save_npy(cache_path(fpath), dm)

            for fpath, bbox in self.parent[disease]:
                dm = np.load(cache_path(fpath))
                key = os.path.split(fpath)[-1]
                report[disease][key] = mean_typicality(bbox, dm)
                auc[disease][key] = aucpr(bbox, dm)
            if not report[disease]:
                del report[disease]
                del auc[disease]
        with open(join(self.output_path, "report.json"), "w") as f:
            json.dump(report, f, indent=4)
        with open(join(self.output_path, "auc.json"), "w") as f:
            json.dump(auc, f, indent=4)
        return report, auc


def compare_json_files(json_pt: str, json_ft: str) -> Dict[str, float]:
    """Pre- vs post-finetune comparison table (reference compute.py:350-389);
    returns {disease: mean AUC improvement}."""
    with open(join(json_pt, "auc.json")) as f:
        data_pt = json.load(f)
    with open(join(json_ft, "auc.json")) as f:
        data_ft = json.load(f)
    out = {}
    print("AUC\n----------")
    rows = []
    for k, vs in data_pt.items():
        # the ft keys may cover another subset: main() drops empty diseases
        keys = [kp for kp in vs if kp in data_ft.get(k, {})]
        if not keys:
            print(f"{k}: no overlapping images between pt and ft — skipped")
            continue
        ft_vals = [data_ft[k][kp] for kp in keys]
        pt_vals = [data_pt[k][kp] for kp in keys]
        print("ft", k, np.mean(ft_vals), "±", np.std(ft_vals))
        print("pt", k, np.mean(pt_vals), "±", np.std(pt_vals))
        out[k] = float(np.mean([f - p for f, p in zip(ft_vals, pt_vals)]))
        print(k, out[k])
        rows += [{"model": "pt", "disease": k, "score": v} for v in pt_vals]
        rows += [{"model": "ft", "disease": k, "score": v} for v in ft_vals]

    # per-image stripplot (reference compute.py:365-378), written beside the
    # ft run's json
    if not rows:
        print("stripplot skipped (no overlapping scores)")
        return out
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import pandas as pd
        import seaborn as sns

        sns.stripplot(x="disease", y="score", data=pd.DataFrame(rows),
                      hue="model", jitter=0.2, dodge=True)
        plt.xlabel("Model")
        plt.ylabel("Value")
        plt.title("Comparison of Values between pt and ft")
        plt.savefig(join(json_ft, "comparison2.png"))
        plt.close()
    except ImportError as e:
        print(f"stripplot skipped ({e})")

    # in-box mean-typicality table (reference compute.py:380-389)
    with open(join(json_pt, "report.json")) as f:
        rep_pt = json.load(f)
    with open(join(json_ft, "report.json")) as f:
        rep_ft = json.load(f)
    print("Typicality\n----------")
    for k, vs in rep_pt.items():
        keys = [kp for kp in vs if kp in rep_ft.get(k, {})]
        if not keys:
            continue
        ft_vals = [rep_ft[k][kp] for kp in keys]
        pt_vals = [rep_pt[k][kp] for kp in keys]
        print("ft", k, np.mean(ft_vals), "±", np.std(ft_vals))
        print("pt", k, np.mean(pt_vals), "±", np.std(pt_vals))
    return out


def predict_bboxes(dm: np.ndarray, kx: int = 64, ky: int = 64, k_per_image: int = 5,
                   ascending: bool = True) -> np.ndarray:
    """Top-k non-overlapping kx x ky boxes scored by the map value at the box
    corner (reference compute.py:220-226); ascending=True picks the least
    typical, as the reference does."""
    h, w = dm.shape
    valid = dm[: h - kx + 1, : w - ky + 1]
    boxes, _ = pool.top_patches(-valid if ascending else valid, kx, ky, k_per_image)
    return boxes


def visualize_boxes(gt_box: Box, dm: np.ndarray, pil: Image.Image) -> Image.Image:
    """GT box + viridis typicality overlay, original | overlay side by side
    (reference compute.py:227-260; PIL instead of cv2, drawing only)."""
    from matplotlib.cm import viridis
    from PIL import ImageDraw

    img = np.asarray(pil.convert("RGB"), dtype=np.float64)
    z = (dm - dm.mean()) / max(dm.std(), 1e-12)
    z = (z - z.min()) / max(z.max() - z.min(), 1e-12)
    colored = np.asarray(viridis(z)) * 255.0  # [H, W, 4]
    alpha = colored[..., 3:4] / 255.0 * 0.7
    over = img * (1 - alpha) + colored[..., :3] * alpha
    out = Image.fromarray(over.astype(np.uint8))
    draw = ImageDraw.Draw(out)
    x1, y1, x2, y2 = gt_box
    draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0), width=2)
    combo = Image.new("RGB", (pil.width * 2, pil.height))
    combo.paste(pil.convert("RGB"), (0, 0))
    combo.paste(out, (pil.width, 0))
    return combo


def merge_triplets(pt: str, ft: str, data_path: str, triplet_path: str) -> None:
    """Stack original / pre-finetune overlay / post-finetune overlay per image
    (reference compute.py:393-409)."""
    os.makedirs(triplet_path, exist_ok=True)
    for disease in os.listdir(pt):
        if disease in ("auc.json", "report.json") or not os.path.isdir(join(pt, disease)):
            continue
        os.makedirs(join(triplet_path, disease), exist_ok=True)
        for image in os.listdir(join(pt, disease)):
            if not image.lower().endswith((".png", ".jpg")):
                continue
            try:
                img_pt = Image.open(join(pt, disease, image))
                img_ft = Image.open(join(ft, disease, image))
                img_data = Image.open(join(data_path, "images", image))
            except FileNotFoundError:
                continue
            half = img_pt.width // 2
            out = Image.new("RGB", (half, img_pt.height * 3))
            out.paste(img_data.convert("RGB"), (0, 0))
            out.paste(img_pt.crop((half, 0, img_pt.width, img_pt.height)), (0, img_pt.height))
            out.paste(img_ft.crop((half, 0, img_ft.width, img_ft.height)), (0, img_pt.height * 2))
            out.save(join(triplet_path, disease, image))


def main(argv=None):
    p = argparse.ArgumentParser(description="X-ray localization eval on the GPU (reference xray/compute.py CLI)")
    p.add_argument("-i", "--gt_path", default="dataset/CXR8")
    p.add_argument("-o", "--output_path", default="results/ct")
    p.add_argument("-m", "--model_path", default="models/CXR8")
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--batch_images", type=int, default=4)
    p.add_argument("--chunk", type=int, default=3,
                   help="samples per UNet call (UNet batch = batch_images*chunk*2)")
    p.add_argument("--blur", action="store_true")
    p.add_argument("--compare", nargs=2, default=None, metavar=("PT", "FT"))
    p.add_argument("--mesh_dp", type=int, default=None,
                   help="shard the sweep over a device mesh (multi-GPU: not ported yet, ROADMAP A12)")
    p.add_argument("--dtype", type=str, default="bf16", choices=sorted(DTYPES),
                   help="compute dtype: bf16 (default), or fp32 for validation runs; both run on the GPU "
                        "(float32 flash kernels) and with --device cpu")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.compare:
        compare_json_files(*args.compare)
        return
    if args.mesh_dp is not None:
        raise SystemExit("--mesh_dp: multi-GPU X-ray sweeps are not ported yet (ROADMAP A12)")

    model_path = args.model_path
    if not os.path.isfile(join(model_path, "model_index.json")):
        from diffmining_tpu_torch.finetuning.export import export_model

        model_path = export_model("xray", model_path, device=args.device)
    sd = SD.from_pipeline_dir("xray", model_path, [], dtype=DTYPES[args.dtype], device=args.device)
    XRayTypicality(
        sd, args.gt_path, args.output_path, DISEASES, N=args.N, blur=args.blur, chunk=args.chunk,
    ).main(batch_images=args.batch_images)


if __name__ == "__main__":
    main()
