"""The CLIP patch-ranking baseline on its device path:
``baselines/clipmining.py`` ``CLIPRankCluster.rank`` with the ViT-L/14-336
towers in float32 (TF32 off, as the port's set-up forces) at the cell's
crop, which interpolates the position embeddings (crop 448: a 32 x 32 grid,
L = 1025, past the flash gate).

Each ``rank(label)`` call ranks a fresh list of ``images_per_call`` image
names of that label (the dataset listing ``load_paths_geo`` would make),
labels alternating; the program's ``load_image`` is given the JPEG bytes of
the name's pool image from memory, which it decodes and resizes with its
own ``resize_center_crop``. The window calls ``rank`` until ``--seconds``
have passed; the rate is every ranked image over the host time.

The check draws images of the first call by the seed, from both halves of
a batch; for them the
benchmark keeps the tower's patch tokens as the program computed them. The
float32 reference decodes and resizes the same bytes itself, runs the
towers, and scores the program's boxes: ``tokens_rel_l2``, ``score_gap``
(the largest gap of a box's pooled score, over the range of the
reference's map) and ``embed_gap`` (the largest distance of a box
embedding, both unit vectors).
"""
from __future__ import annotations

import io
import os
import random
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench import counts, traffic, weights
from portbench.entries.common import attention_spans, free, halves, port_module, reference, ref_spec, rel_l2
from portbench.harness import Window
from portbench.reference.clip import TextEncoder, VisionTower
from portbench.reference.common import Precision
from portbench.seeds import derive
from portbench.tracing import patched, span

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def towers(run):
    from diffmining_tpu_torch.models.clip import CLIPTextModelWithProjection, CLIPVisionModel
    from diffmining_tpu_torch.utils.weights import clip_config_from_json, clip_vision_config_from_json

    cfg, dev, proj = run.config, run.device, run.config["projection_dim"]
    vision = port_module(lambda: CLIPVisionModel(clip_vision_config_from_json(cfg)),
                         weights.make(ref_spec(lambda: VisionTower(cfg["vision_config"], proj)), run.seed, "vision",
                                      dev), dev)
    text = port_module(lambda: CLIPTextModelWithProjection(clip_config_from_json(cfg["text_config"]), proj),
                       weights.make(ref_spec(lambda: TextEncoder(cfg["text_config"], proj)), run.seed, "text", dev),
                       dev)
    return vision, text


def apply_fault(run, vision) -> None:
    """"altered" scales the patch tokens where the tower produces them;
    "half_batch" runs the first half of a chunk and repeats it."""
    if run.fault is None:
        return
    orig = vision.forward

    def forward(pixels):
        if run.fault == "altered":
            pooled, tokens = orig(pixels)
            return pooled, tokens * 1.25
        if run.fault == "half_batch":
            pooled, tokens = orig(pixels[:pixels.shape[0] // 2])
            return torch.cat([pooled, pooled]), torch.cat([tokens, tokens])
        raise ValueError(run.fault)

    vision.forward = forward


class Images:
    """Name k is pool image k % distinct, as JPEG bytes, with label k % 2."""

    def __init__(self, run):
        tr = run.traffic
        pool = traffic.images(run.seed, "pool", tr["distinct_images"], tr["height"], tr["width"], run.device)
        self.jpeg = [traffic.jpeg_bytes(x) for x in pool]
        self.labels = list(tr["labels"])
        self.root = os.path.join(run.scratch, "images")

    def path(self, k: int) -> str:
        label = self.labels[k % len(self.labels)]
        return os.path.join(self.root, label, f"gt--{label}__{k:07d}.jpg")

    def k(self, path: str) -> int:
        return int(os.path.basename(path).rsplit("__", 1)[1][:7])

    def pil(self, k: int):
        from PIL import Image

        return Image.open(io.BytesIO(self.jpeg[k % len(self.jpeg)])).convert("RGB")


def setup(run):
    from diffmining_tpu_torch.baselines.clipmining import CLIPRankCluster, resize_center_crop

    tr = run.traffic
    vision, text = towers(run)
    apply_fault(run, vision)
    imgs = Images(run)
    for label in imgs.labels:
        os.makedirs(os.path.join(imgs.root, label), exist_ok=True)
    rc = CLIPRankCluster(imgs.root, os.path.join(run.scratch, "clip"), tr["mode"], vision=vision, text=text,
                         tokenizer=traffic.Tokenizer(run.config["text_config"]["vocab_size"]), crop=tr["crop"],
                         batch_images=tr["batch_images"], device=run.device)

    def load_image(path):
        k = imgs.k(path)
        img = resize_center_crop(imgs.pil(k), rc.crop)
        img.info["pb_k"] = k
        return img

    rc.load_image = load_image
    n = int(tr["images_per_call"])
    rng = random.Random(derive(run.seed, "check"))
    keep = set(halves(rng, list(range(n)), int(tr["batch_images"]), int(run.workload["check"]["images"])))
    kept: Dict[int, torch.Tensor] = {}

    def project_factory(orig):
        def project(images, pad_to=None):
            tokens, pw = orig(images, pad_to)
            for j, im in enumerate(images):
                if im.info.get("pb_k") in keep:
                    kept[im.info["pb_k"]] = tokens[j].cpu()
            return tokens, pw

        return project

    rc._project_device = project_factory(rc._project_device)
    cell = {"rc": rc, "imgs": imgs, "next": 10 ** 6, "ranked": [], "kept": kept}
    rank_call(run, cell)  # the warm-up call: every shape of the window
    cell["next"], cell["ranked"] = 0, []
    kept.clear()
    return cell


def rank_call(run, cell) -> int:
    """One ``rank`` over the next ``images_per_call`` names of one label."""
    rc, imgs, n = cell["rc"], cell["imgs"], int(run.traffic["images_per_call"])
    first = cell["next"]
    label = imgs.labels[(first // n) % len(imgs.labels)]
    names = [imgs.path(k) for k in range(first, first + n)]
    rc.country_path[label] = [(p, True) for p in names]
    df, embeds = rc.rank(label, k_per_image=run.traffic["k_per_image"])
    cell["ranked"].append((label, first, df, np.stack(embeds)))
    cell["next"] = first + n
    return n


def window(run, cell) -> Window:
    t0 = time.perf_counter()
    units = 0
    while units == 0 or time.perf_counter() - t0 < run.seconds:
        units += rank_call(run, cell)
    return Window(units, time.perf_counter() - t0)


def traced(run, cell):
    import contextlib

    import diffmining_tpu_torch.baselines.clipmining as port_rank
    import diffmining_tpu_torch.models.clip as port_clip

    cfg, tr, rc = run.config, run.traffic, cell["rc"]
    vjson = _key(cfg["vision_config"])
    proj = cfg["projection_dim"]
    counts.vision_flops("vision", vjson, proj, tr["batch_images"], tr["crop"], tr["crop"])

    def vision_factory(orig):
        def forward(pixels):
            run.work.append(("flops", counts.vision_flops("vision", vjson, proj, pixels.shape[0], pixels.shape[2],
                                                          pixels.shape[3])))
            with span("pb.vision"):
                return orig(pixels)

        return forward

    def spanned(name):
        def factory(orig):
            def call(*a, **kw):
                with span(name):
                    return orig(*a, **kw)

            return call

        return factory

    def work() -> Window:
        t0 = time.perf_counter()
        units = 0
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(rc.vision, "forward", vision_factory))
            stack.enter_context(patched(rc, "load_image", spanned("pb.load")))
            for fn in ("preprocess", "top_patches", "_pooled_score_maps", "_box_embeds"):
                stack.enter_context(patched(port_rank, fn, spanned(f"pb.{fn.strip('_')}")))
            for p in attention_spans(run, [port_clip], "fp32"):
                stack.enter_context(p)
            for _ in range(int(run.workload["trace"]["calls"])):
                units += rank_call(run, cell)
        run.counters.add("images", units)
        return Window(units, time.perf_counter() - t0)

    return work


def _key(d) -> str:
    import json

    return json.dumps(d, sort_keys=True)


def metrics(run, win: Window) -> Dict[str, float]:
    return {"rank_images_per_s": win.units / win.seconds}


def release(run, cell):
    out = {"ranked": cell["ranked"], "kept": dict(cell["kept"]), "imgs": cell["imgs"],
           "crop": cell["rc"].crop, "patch": cell["rc"].vision.config.patch_size}
    cell.clear()
    free()
    return out


def ref_pixels(imgs: Images, k: int, crop: int, device) -> torch.Tensor:
    """The reference's own decode, resize (shortest side to ``crop``,
    bicubic, then a centred square) and CLIP normalisation."""
    from PIL import Image

    img = imgs.pil(k)
    w, h = img.size
    if min(w, h) != crop:
        w, h = (crop, max(crop, round(h * crop / w))) if w <= h else (max(crop, round(w * crop / h)), crop)
        img = img.resize((w, h), Image.BICUBIC)
    left, top = max(0, (w - crop) // 2), max(0, (h - crop) // 2)
    x = np.asarray(img.crop((left, top, left + crop, top + crop)), dtype=np.float32) / 255.0
    x = (x - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD, np.float32)
    return torch.from_numpy(x).permute(2, 0, 1)[None].to(device)


def reference_rank(run, models, pixels, label, prec: Precision, kx: int = 64, ky: int = 64):
    """(tokens [N, P], diff map [H-kx+1, W-ky+1], upsampled unit-free token
    features [P, H, W]) of one image."""
    vision, text = models
    tok = traffic.Tokenizer(run.config["text_config"]["vocab_size"])
    ids = torch.from_numpy(tok([label, ""])).to(run.device)
    with prec.active(), torch.no_grad():
        te = text.pooled(ids)
        te = te / te.norm(dim=-1, keepdim=True)
        _, tokens = vision(pixels)
        tokens = tokens[0]
        g = int(round(tokens.shape[0] ** 0.5))
        unit = tokens / tokens.norm(dim=-1, keepdim=True)
        scores = (unit @ te.t()).t().reshape(1, 2, g, g)
        h, w = pixels.shape[2:]
        up = F.interpolate(scores, size=(h, w), mode="bilinear", align_corners=False)
        pooled = F.avg_pool2d(up, (kx, ky), stride=1)[0]
        feats = F.interpolate(tokens.t().reshape(1, -1, g, g), size=(h, w), mode="bilinear", align_corners=False)[0]
    return tokens, pooled[0] - pooled[1], feats


def reference_models(run, precision: str):
    cfg, dev, proj = run.config, run.device, run.config["projection_dim"]
    return (reference(lambda: VisionTower(cfg["vision_config"], proj), run.seed, "vision", dev, torch.float32,
                      precision),
            reference(lambda: TextEncoder(cfg["text_config"], proj), run.seed, "text", dev, torch.float32,
                      precision))


def check(run, outputs, precision: str = "fp32", control: str | None = None) -> Dict[str, float]:
    imgs, kept = outputs["imgs"], outputs["kept"]
    n = int(run.traffic["images_per_call"])
    rows = {}
    for label, first, df, emb in outputs["ranked"][:1]:
        for i, r in enumerate(df.itertuples(index=False)):
            rows.setdefault(imgs.k(r.seed), []).append(((r.x_start, r.y_start, r.x_end, r.y_end), r.D, emb[i]))
    ks = sorted(kept)
    if len(ks) < min(int(run.workload["check"]["images"]), n):
        return {"tokens_rel_l2": float("inf"), "score_gap": float("inf"), "embed_gap": float("inf")}
    models = reference_models(run, precision)
    stand_in = reference_models(run, control) if control else None
    got_t, want_t, score_gap, embed_gap = [], [], 0.0, 0.0
    for k in ks:
        label = imgs.labels[(k // n) % len(imgs.labels)]
        pixels = ref_pixels(imgs, k, outputs["crop"], run.device)
        tokens, dmap, feats = reference_rank(run, models, pixels, label, Precision(precision))
        want_t.append(tokens.cpu())
        if stand_in is not None:
            c_tokens, c_map, c_feats = reference_rank(run, stand_in, pixels, label, Precision(control))
            got_t.append(c_tokens.cpu())
            boxes = [((x0, y0, x0 + 64, y0 + 64), float(c_map[x0, y0]),
                      _box(c_feats, x0, y0)) for x0, y0 in _top(c_map, 5)]
        else:
            got_t.append(kept[k])
            boxes = rows.get(k, [])
        span_ = float(dmap.max() - dmap.min())
        for (x0, y0, x1, y1), d, e in boxes:
            score_gap = max(score_gap, abs(float(d) - float(dmap[x0, y0])) / span_)
            ref_e = _box(feats, x0, y0, x1 - x0, y1 - y0)
            embed_gap = max(embed_gap, float(np.linalg.norm(np.asarray(e, np.float64) - ref_e)))
    del models, stand_in
    free()
    return {"tokens_rel_l2": rel_l2(torch.stack(got_t), torch.stack(want_t)), "score_gap": score_gap,
            "embed_gap": embed_gap}


def _box(feats: torch.Tensor, x0: int, y0: int, kx: int = 64, ky: int = 64) -> np.ndarray:
    e = feats[:, x0:x0 + kx, y0:y0 + ky].reshape(feats.shape[0], -1).mean(dim=1).double().cpu().numpy()
    return e / max(np.linalg.norm(e), 1e-12)


def _top(dmap: torch.Tensor, k: int):
    """The ``k`` highest positions of the map (the control's own boxes)."""
    idx = torch.topk(dmap.flatten(), k).indices.cpu().numpy()
    return [divmod(int(i), dmap.shape[1]) for i in idx]
