"""CLIP patch-ranking baseline (counterpart of diffmining_tpu/baselines/
clipmining.py; reference clipmining/ranking.py).

The vision tower's patch tokens, projected through ``visual_projection``,
are scored against the [country, ""] text embeddings; the raw-similarity
difference (mode "diff") or similarity ("sim") map is upsampled to the
image, box-pooled, and the top-k non-overlapping patches are mined and
clustered with k-means(32) ranked by median score: the reference's
constants. Images are resized to ``crop`` on the shortest side and centre-
cropped square (the reference processor's effective transform); ``crop``
defaults to the tower's ``image_size``, and other sizes interpolate the
position embeddings.

Two scoring paths, as in JAX. The device path (default) batches the pooled
score maps over an encode chunk and never forms the upsampled token
features: bilinear resize is linear and separable, so a box mean of them is
exactly u^T · token_grid · v with u, v the box-averaged rows of the 1-D
resize matrices (``_resize_weights``), and only [k, D] a image comes back.
The host path (``DIFFMINING_CLIP_HOST_SCORING=1``) upsamples the [D, H, W]
features of each image on the host, as the reference does. The towers run
on ``device`` (the card unless the caller asks for the CPU) in float32.

    python -m diffmining_tpu_torch clipmining --dataset DATA --cache CACHE \\
        [--clip_dir CLIPMODEL_DIR]
"""
from __future__ import annotations

import argparse
import functools
import os
import pickle
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch
from PIL import Image

from diffmining_tpu_torch.models.clip import (
    CLIP_VIT_L_TEXT,
    CLIP_VIT_L_VISION_336,
    CLIPTextModelWithProjection,
    CLIPVisionModel,
)
from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer, tiny_tokenizer
from diffmining_tpu_torch.ops.kmeans import KMeans
from diffmining_tpu_torch.ops.pool import box_pool, top_patches, upsample_bilinear
from diffmining_tpu_torch.typicality.compute import init_random_
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.figures import make_grid

PATCH_COLUMNS = ["seed", "x_start", "y_start", "x_end", "y_end", "D"]

# CLIP normalization constants (the processor's means and stds)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

_HOST_SCORING = os.environ.get("DIFFMINING_CLIP_HOST_SCORING", "0") == "1"


@functools.lru_cache(maxsize=None)
def _resize_weights(n: int, m: int) -> np.ndarray:
    """[m, n] matrix of the bilinear resize from n to m samples (upsampling;
    identity at n == m): the resize of eye(n) is the matrix."""
    eye = torch.eye(n, dtype=torch.float32)
    return upsample_bilinear(eye, m, n).numpy()


def _pooled_score_maps(tokens: torch.Tensor, text_embeds: torch.Tensor, ph: int, pw: int, h: int, w: int,
                       kx: int, ky: int, diff: bool) -> torch.Tensor:
    """tokens [B, P, D] (raw visual_projection outputs), text_embeds [2, D]
    L2-normalised -> pooled [B, h-kx+1, w-ky+1] fp32 (diff: country - "")."""
    tok = tokens / torch.linalg.norm(tokens, dim=-1, keepdim=True)
    scores = torch.einsum("bpd,cd->bcp", tok, text_embeds)
    up = upsample_bilinear(scores.reshape(scores.shape[0], scores.shape[1], ph, pw), h, w)
    pooled = box_pool(up, kx, ky)
    return pooled[:, 0] - pooled[:, 1] if diff else pooled[:, 0]


def _box_embeds(tokens: torch.Tensor, u: torch.Tensor, v: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Exact box means of the upsampled token grid: tokens [B, P, D], u [B,
    k, ph], v [B, k, pw] -> L2-normalised [B, k, D]."""
    grid = tokens.reshape(tokens.shape[0], ph, pw, tokens.shape[-1])
    e = torch.einsum("bkp,bpqd,bkq->bkd", u, grid, v)
    return e / torch.clamp_min(torch.linalg.norm(e, dim=-1, keepdim=True), 1e-12)


def resize_center_crop(img: Image.Image, size: int) -> Image.Image:
    """Shortest side -> ``size`` (bicubic), then a centred square crop."""
    w, h = img.size
    if min(w, h) != size:
        if w <= h:
            w, h = size, max(size, round(h * size / w))
        else:
            w, h = max(size, round(w * size / h)), size
        img = img.resize((w, h), Image.BICUBIC)
    left, top = max(0, (w - size) // 2), max(0, (h - size) // 2)
    return img.crop((left, top, left + size, top + size))


def preprocess(img: Image.Image) -> np.ndarray:
    """PIL RGB -> CLIP-normalised float32 [H, W, 3]."""
    return (np.asarray(img, dtype=np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def random_vision_tower(config, generator: torch.Generator) -> CLIPVisionModel:
    """A vision tower with flax's default init drawn from ``generator`` (the
    class embedding N(0, 0.02²), as the JAX tower's)."""
    vision = CLIPVisionModel(config)
    init_random_(vision, generator)
    with torch.no_grad():
        vision.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=generator)
    return vision


def random_towers(vision: Optional[CLIPVisionModel], text: Optional[CLIPTextModelWithProjection], seed: int = 0):
    """Seeded random towers for whichever is missing (ViT-L/14-336 and the
    ViT-L text tower): the pipeline runs, the mining means nothing."""
    g = torch.Generator()
    g.manual_seed(seed)
    if vision is None:
        vision = random_vision_tower(CLIP_VIT_L_VISION_336, g)
    if text is None:
        text = CLIPTextModelWithProjection(CLIP_VIT_L_TEXT, projection_dim=vision.config.projection_dim)
        init_random_(text, g)
    return vision, text


class CLIPRankCluster:
    def __init__(
        self,
        dataset_path: str,
        cache_path: str = "clip",
        mode: str = "diff",
        vision: Optional[CLIPVisionModel] = None,
        text: Optional[CLIPTextModelWithProjection] = None,
        tokenizer: Optional[CLIPTokenizer] = None,
        crop: Optional[int] = None,
        batch_images: int = 8,
        host_scoring: Optional[bool] = None,
        device="cuda",
    ):
        if mode not in ("diff", "sim"):
            raise ValueError(f"mode must be 'diff' or 'sim', got {mode!r}")
        self.host_scoring = _HOST_SCORING if host_scoring is None else host_scoring
        self.mode = mode
        self.dataset_path = dataset_path
        self.cache_path = join(cache_path, mode)
        self.device = resolve_device(device)
        self.load_paths_geo(dataset_path)
        if vision is None or text is None:
            print("clipmining: no CLIP weights supplied — towers are RANDOMLY initialized (smoke/test only); "
                  "pass --clip_dir for real mining", flush=True)
            vision, text = random_towers(vision, text)
        self.vision = vision.to(self.device, torch.float32).eval()
        self.text = text.to(self.device, torch.float32).eval()
        self.crop = crop if crop is not None else self.vision.config.image_size
        self.tokenizer = tokenizer if tokenizer is not None else tiny_tokenizer(self.text.config.vocab_size)
        self.batch_images = max(int(batch_images), 1)

    # --- dataset protocol (the geo loader's) ---

    def load_paths_geo(self, dataset_path: str) -> None:
        self.parent = {}
        self.country_path = defaultdict(list)
        for country_parent in sorted(os.listdir(dataset_path)):
            output_dir = join(dataset_path, country_parent)
            if not os.path.isdir(output_dir):
                continue
            for seed in sorted(os.listdir(output_dir)):
                country = seed.split("__")[0]
                if country.startswith("gt--"):
                    self.country_path[country.replace("gt--", "")].append((join(output_dir, seed), True))
                elif "--" not in country:
                    self.country_path[country].append((join(output_dir, seed), False))
            self.parent[country_parent] = True

    def categories(self) -> List[str]:
        return sorted(self.parent.keys())

    def get_seeds(self, c: str) -> List[str]:
        return [p for p, is_gt in self.country_path[c] if is_gt]

    # --- encode ---

    def load_image(self, path: str) -> Image.Image:
        return resize_center_crop(Image.open(path).convert("RGB"), self.crop)

    def project_image(self, img: Image.Image) -> Tuple[np.ndarray, int]:
        """-> (patch tokens through visual_projection [P, D], patch grid width)."""
        tokens, pw = self.project_images([img], pad_to=1)
        return tokens[0], pw

    def project_images(self, imgs: Sequence[Image.Image], pad_to: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """One batched tower pass -> (tokens [B, P, D] on the host, patch
        grid width)."""
        tokens, pw = self._project_device(imgs, pad_to)
        return tokens[: len(imgs)].cpu().numpy(), pw

    @torch.no_grad()
    def _project_device(self, imgs: Sequence[Image.Image], pad_to: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """The tokens on the device, the batch padded to ``pad_to`` (default
        ``batch_images``) by repeating the last image, so every chunk has
        one shape."""
        n = len(imgs)
        pad_to = self.batch_images if pad_to is None else max(pad_to, 1)
        x = np.stack([preprocess(im) for im in imgs])
        if n < pad_to:
            x = np.concatenate([x, np.repeat(x[-1:], pad_to - n, axis=0)])
        pixels = torch.from_numpy(x).permute(0, 3, 1, 2).to(self.device)
        _, tokens = self.vision(pixels)
        return tokens.float(), imgs[0].width // self.vision.config.patch_size

    @torch.no_grad()
    def project_text(self, prompts: Sequence[str]) -> np.ndarray:
        ids = torch.from_numpy(self.tokenizer(list(prompts))).long().to(self.device)
        _, pooled = self.text(ids)
        pooled = pooled.float().cpu().numpy()
        return pooled / np.linalg.norm(pooled, axis=-1, keepdims=True)

    # --- scoring (the reference's dot_text_image) ---

    def score_map(self, tokens: np.ndarray, pw: int, text_embeds: np.ndarray, size: Tuple[int, int],
                  kx: int = 64, ky: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Host path: -> (pooled score map, upsampled token features [D, H, W])."""
        tok = tokens / np.linalg.norm(tokens, axis=-1, keepdims=True)
        scores = tok @ text_embeds.T  # [P, 2]
        ph = tokens.shape[0] // pw
        up = upsample_bilinear(torch.from_numpy(np.ascontiguousarray(scores.reshape(ph, pw, 2).transpose(2, 0, 1))),
                               *size)
        if self.mode == "diff":
            # the pooled raw-similarity difference country - "": the
            # reference's live path (its softmax, ranking.py:77, is never read)
            pooled = (box_pool(up[0][None], kx, ky)[0] - box_pool(up[1][None], kx, ky)[0]).numpy()
        else:
            pooled = box_pool(up[0][None], kx, ky)[0].numpy()
        feats = upsample_bilinear(torch.from_numpy(np.ascontiguousarray(tokens.T.reshape(-1, ph, pw))), *size)
        return pooled, feats.numpy()

    def rank(self, country: str, k_per_image: int = 5, kx: int = 64, ky: int = 64):
        text_embeds = self.project_text([country, ""])
        rows, embeds = [], []
        seeds = self.get_seeds(country)
        if self.host_scoring:
            for start in range(0, len(seeds), self.batch_images):
                chunk = seeds[start:start + self.batch_images]
                imgs = [self.load_image(p) for p in chunk]
                tokens_b, pw = self.project_images(imgs)
                for path, img, tokens in zip(chunk, imgs, tokens_b):
                    pooled, feats = self.score_map(tokens, pw, text_embeds, (img.height, img.width), kx, ky)
                    boxes, scores = top_patches(pooled, kx, ky, k_per_image)
                    for (x0, y0, x1, y1), s in zip(boxes, scores):
                        rows.append((path, x0, y0, x1, y1, float(s)))
                        crop = feats[:, x0:x1, y0:y1].reshape(feats.shape[0], -1).mean(axis=1)
                        embeds.append(crop / max(np.linalg.norm(crop), 1e-12))
            return pd.DataFrame(rows, columns=PATCH_COLUMNS), embeds

        # device path: batched pooled maps, [k, D] box embeddings, and the
        # next chunk's decodes prefetched while the device computes
        te = torch.from_numpy(text_embeds).to(self.device)
        chunks = [seeds[s:s + self.batch_images] for s in range(0, len(seeds), self.batch_images)]
        load = lambda c: [self.load_image(p) for p in c]  # noqa: E731
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(load, chunks[0]) if chunks else None
            for ci, chunk in enumerate(chunks):
                imgs = fut.result()
                if ci + 1 < len(chunks):
                    fut = pool.submit(load, chunks[ci + 1])
                tokens_dev, pw = self._project_device(imgs)
                ph = tokens_dev.shape[1] // pw
                h, w = imgs[0].height, imgs[0].width
                pooled_b = _pooled_score_maps(tokens_dev, te, ph, pw, h, w, kx, ky, self.mode == "diff").cpu().numpy()
                wh, ww = _resize_weights(ph, h), _resize_weights(pw, w)
                u = np.zeros((len(tokens_dev), k_per_image, ph), np.float32)
                v = np.zeros((len(tokens_dev), k_per_image, pw), np.float32)
                counts = []
                for bi, path in enumerate(chunk):
                    boxes, scores = top_patches(pooled_b[bi], kx, ky, k_per_image)
                    counts.append(len(boxes))
                    for j, ((x0, y0, x1, y1), s) in enumerate(zip(boxes, scores)):
                        rows.append((path, x0, y0, x1, y1, float(s)))
                        u[bi, j] = wh[x0:x1].mean(axis=0)
                        v[bi, j] = ww[y0:y1].mean(axis=0)
                emb_b = _box_embeds(tokens_dev, torch.from_numpy(u).to(self.device),
                                    torch.from_numpy(v).to(self.device), ph, pw).cpu().numpy()
                for bi in range(len(chunk)):
                    embeds.extend(emb_b[bi, :counts[bi]])
        return pd.DataFrame(rows, columns=PATCH_COLUMNS), embeds

    # --- clustering (the reference's constants) ---

    def cluster(self, df: pd.DataFrame, embeds, num_clusters: int = 32):
        km = KMeans(n_clusters=num_clusters, random_state=10, device=str(self.device)).fit(np.stack(embeds))
        clusters = defaultdict(list)
        for i, l in enumerate(km.labels_):
            row = df.iloc[i]
            x0, y0, x1, y1 = (int(row[c]) for c in ["x_start", "y_start", "x_end", "y_end"])
            pil = self.load_image(row["seed"]).crop((y0, x0, y1, x1))
            name = os.path.split(row["seed"])[1]
            idd = os.path.splitext(name)[0] + f"_{x0}-{y0}-{x1}-{y1}"
            clusters[int(l)].append((pil, row["D"], idd, embeds[i], row["seed"]))
        ranked = []
        for k, vs in clusters.items():
            vs = sorted(vs, key=lambda v: float(np.linalg.norm(v[3] - km.cluster_centers_[k])))
            ranked.append(([(a, b, c, e) for a, b, c, d, e in vs], float(np.median([v[1] for v in vs]))))
        return sorted(ranked, key=lambda kv: kv[1], reverse=True)

    def clustering(self, k_per_image: int = 5, k: int = 1000, num_clusters: int = 32, hard_limit: int = 6,
                   kx: int = 64, ky: int = 64):
        cache_path = join(self.cache_path, "dfs")
        figure_dir = join(self.cache_path, "figures")
        os.makedirs(cache_path, exist_ok=True)
        os.makedirs(figure_dir, exist_ok=True)
        results = {}
        for country in self.categories():
            # non-default mining parameters key the cache name; the defaults
            # keep the reference's bare {country}.pkl
            tag = "" if (k_per_image, kx, ky) == (5, 64, 64) else f"__{k_per_image}-{kx}-{ky}"
            fp = join(cache_path, country + tag + ".pkl")
            if os.path.isfile(fp):
                with open(fp, "rb") as f:
                    df, embeds = pickle.load(f)
            else:
                df, embeds = self.rank(country, k_per_image=k_per_image, kx=kx, ky=ky)
                with open(fp, "wb") as f:
                    pickle.dump((df, embeds), f)

            order = np.argsort(-df["D"].to_numpy(), kind="stable")[:k]
            df_top = df.iloc[order].reset_index(drop=True)
            embs = [embeds[i] for i in order]
            clusters = self.cluster(df_top, embs, num_clusters=num_clusters)
            results[country] = clusters

            parent_ = join(self.cache_path, "images", "clusters", country)
            os.makedirs(parent_, exist_ok=True)
            grid = []
            for i, (members, _score) in enumerate(clusters):
                row_imgs = []
                for j, (pil, _d, idd, _p) in enumerate(members):
                    pil.save(join(parent_, f"{i}-{j}-{num_clusters}_{idd}.png"))
                    if j < hard_limit:
                        row_imgs.append(pil.convert("RGB"))
                if row_imgs:
                    grid.append(row_imgs)
            if grid:
                make_grid(grid, 2, 4).save(join(figure_dir, f"{country}.png"))
        return results


def load_towers(clip_dir: str):
    """(vision, text, tokenizer) from a CLIPModel dir (utils/weights.py
    ``load_clip_dir``)."""
    from diffmining_tpu_torch.utils.weights import load_clip_dir, load_state

    bundle = load_clip_dir(clip_dir)
    vision = CLIPVisionModel(bundle["vision"]["config"])
    load_state(vision, bundle["vision"]["state_dict"])
    text = CLIPTextModelWithProjection(bundle["text"]["config"], projection_dim=bundle["text"]["projection_dim"])
    load_state(text, bundle["text"]["state_dict"])
    tok_dir = bundle["tokenizer_dir"]
    if not os.path.isfile(join(tok_dir, "vocab.json")):
        raise FileNotFoundError(f"no tokenizer files (vocab.json) in {tok_dir}")
    return vision, text, CLIPTokenizer.from_pretrained_dir(tok_dir)


def main(argv=None):
    p = argparse.ArgumentParser(description="CLIP patch-ranking baseline on the GPU (reference clipmining CLI)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--cache", type=str, default="clip")
    p.add_argument("--mode", type=str, default="diff", choices=["diff", "sim"])
    p.add_argument("--clip_dir", type=str, default=None,
                   help="dir with CLIPModel weights (vision+text safetensors + config.json), e.g. converted StreetCLIP")
    p.add_argument("--crop", type=int, default=None, help="input size; defaults to the vision tower's image_size")
    p.add_argument("--batch_images", type=int, default=8,
                   help="images per batched vision-tower pass (the reference encodes one at a time)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    towers = {}
    if args.clip_dir:
        vision, text, tokenizer = load_towers(args.clip_dir)
        towers = dict(vision=vision, text=text, tokenizer=tokenizer)
    rc = CLIPRankCluster(args.dataset, args.cache, args.mode, crop=args.crop, batch_images=args.batch_images,
                         device=args.device, **towers)
    rc.clustering(k_per_image=5, k=1000, num_clusters=32, hard_limit=6)


if __name__ == "__main__":
    main()
