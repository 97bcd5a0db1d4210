"""Mining and clustering: score maps, patch tables, DIFT embeddings,
k-means and ranked clusters (counterpart of diffmining_tpu/typicality/
cluster.py; reference diffmining/typicality/cluster.py).

The artifact and cache contract is the JAX package's and the reference's:
per-category pickled (top, random) patch tables under
``{cache}/clusters/``, per-patch embedding pickles under
``{cache}/embeddings/{feature_which}/``, member crops under
``{cache}/images/clusters/ranked/{feature_which}/{category}/`` named
``{rank}-{member}-{num_clusters}_{id}.png``, and the figures. The score
maps, the DIFT ensembles and k-means run on ``device`` (the card unless the
caller asks for the CPU); suppression and top-k are host numpy.

The feature modes are ``dift-{t}``, ``clip`` (the CLIP image embedding of
the patch crop, L2-normalised; the reference's openai/clip-vit-base-patch32
from ``--clip_dir``) and ``clip+dift-{t}`` (their concatenation, [clip |
dift]). Not yet: ``--mesh_dp`` (multi-GPU, ROADMAP A12) raises.

    python -m diffmining_tpu_torch cluster -w ftt -d DATA -t TREE -c CACHE \\
        -m PIPELINE_DIR --cluster
"""
from __future__ import annotations

import argparse
import functools
import os
import pickle
import random
from collections import defaultdict
from os.path import join
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch
from PIL import Image

from diffmining_tpu_torch.ops.kmeans import KMeans
from diffmining_tpu_torch.ops.pool import (
    filter_patch,
    gaussian_blur,
    pixel_typicality_map,
    top_patches,
    typicality_map,
)
from diffmining_tpu_torch.typicality.compute import DTYPES, SD, D, Typicality
from diffmining_tpu_torch.typicality.dift import SDFeaturizer
from diffmining_tpu_torch.typicality.templates import dift_prompt
from diffmining_tpu_torch.utils.artifacts import atomic_save_pickle
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.figures import add_border, hcat_margin, make_grid
from diffmining_tpu_torch.utils.images import array_from_uint8, image_uid, rescale_for_domain

PATCH_COLUMNS = ["seed", "x_start", "y_start", "x_end", "y_end", "D", "origin"]


def normalize(dm: np.ndarray) -> np.ndarray:
    """Reference cluster.py:32-48 normalization for alpha overlays: the
    negative and positive parts scaled to [-1, 0] and [0, 1] separately,
    then mapped to [0, 1]."""
    dm = dm.copy()
    neg, pos = np.abs(np.min(dm)), np.max(dm)
    if neg > 0:
        dm[dm < 0] = dm[dm < 0] / neg
    if pos > 0:
        dm[dm > 0] = dm[dm > 0] / pos
    return (dm + 1) / 2.0


def filter_by_contrast(
    arr: np.ndarray, fraction_threshold: float = 0.05,
    lower_percentile: float = 1, upper_percentile: float = 99, method: str = "linear",
) -> bool:
    """True when the patch is NOT low-contrast (reference utils.py:230-231,
    skimage exposure.is_low_contrast semantics): the [lower, upper] percentile
    spread of the grayscale intensities, normalized by the dtype range, must
    exceed `fraction_threshold`."""
    a = np.asarray(arr)
    limit = 255.0 if a.dtype == np.uint8 else 1.0
    if a.ndim == 3:  # rgb2gray luminance (skimage weights)
        a = a[..., :3] @ np.array([0.2125, 0.7154, 0.0721])
    lo, hi = np.percentile(a, [lower_percentile, upper_percentile], method=method)
    return float(hi - lo) / limit > fraction_threshold


def filter_by_gradient(
    arr: np.ndarray, fraction_threshold: float = 0.05,
    lower_percentile: float = 0.01, upper_percentile: float = 0.99,
) -> bool:
    """True when the mean local gradient is above threshold (reference
    utils.py:233-235: skimage rank.gradient_percentile with a 3x3 footprint —
    per pixel, the [p0, p1]-percentile spread of its neighborhood). Borders
    use edge replication (skimage's sliding-histogram rank filter mirrors;
    on 3x3 footprints the two agree except at the 1-px frame)."""
    a = np.asarray(arr)
    if a.ndim == 3:
        a = (a[..., :3] @ np.array([0.2125, 0.7154, 0.0721]))
    a = a.astype(np.float64)
    p = np.pad(a, 1, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(p, (3, 3)).reshape(*a.shape, 9)
    lo = np.quantile(win, lower_percentile, axis=-1)
    hi = np.quantile(win, upper_percentile, axis=-1)
    return float(np.mean(hi - lo)) > fraction_threshold


PATCH_FILTERS = {"contrast": filter_by_contrast, "gradient": filter_by_gradient}


def mean_agg(vs):
    return sum(v[1] for v in vs) / (1.0 * len(vs))


def median_agg(vs):
    return float(np.median([v[1] for v in vs]))


class Cluster(Typicality):
    def __init__(
        self,
        which: str,
        typicality_path: str,
        dataset_path: str,
        cache_path: str,
        recache: bool = False,
        model_path: Optional[str] = None,
        aggregate: str = "median",
        kx: int = 64,
        ky: int = 64,
        cache_features: bool = True,
        dift_sd: Optional[SD] = None,
        native_res: bool = False,
        mesh=None,
        device="cuda",
        dtype=torch.bfloat16,
        dift_draws: Optional[Callable] = None,
        clip_dir: Optional[str] = None,
        clip_bundle: Optional[dict] = None,
    ):
        if mesh is not None:
            raise NotImplementedError("--mesh_dp (DIFT over a device mesh) is not ported yet (ROADMAP A12)")
        # model-free init: score maps only need the artifacts (reference
        # cluster.py:58 passes model_path=None to Typicality)
        super().__init__(
            which=which, model_path=None, dataset_path=dataset_path,
            typicality_path=typicality_path, native_res=native_res, device=device,
        )
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dift_draws = dift_draws
        self.cache_path = cache_path
        self.recache = recache
        self.kx = kx
        self.ky = ky
        self.model_path = model_path
        self.aggregate = median_agg if aggregate == "median" else mean_agg
        self.cache_features = cache_features
        self._dift_sd = dift_sd
        self.dift: Optional[SDFeaturizer] = None
        # CLIP patch features (the clip and clip+dift-* modes): a converted
        # CLIPModel dir, or an injected {"config", "state_dict"} of the
        # vision tower
        self.clip_dir = clip_dir
        self._clip_bundle = clip_bundle
        self._clip_embed: Optional[Callable] = None

    # ------------------------------------------------------------------
    # score maps
    # ------------------------------------------------------------------

    def get_seeds(self, d: D, tag: str) -> List[str]:
        if self.which in ("ftt", "cars"):
            return [p for p in self.times[tag] if d.exists(p)]
        if self.which == "geo":
            return [p for p, is_gt in self.country_path[tag] if is_gt and d.exists(p)]
        return [p for p in self.parent[tag] if d.exists(p)]

    def load_image(self, path: str, pil: bool = True):
        img = Image.open(path).convert("RGB")
        # must mirror the sweep's geometry (compute.D) or patch boxes and
        # upsampled maps would disagree with the stored artifacts
        img = rescale_for_domain(img, self.which, native=self.native_res)
        return img if pil else np.asarray(img) / 255.0

    def load_typicality(self, d: D, path: str) -> np.ndarray:
        """Patch-score map [(h-kx+1), (w-ky+1)] (reference cluster.py:125-137)."""
        w, h = self.load_image(path).size
        grid = torch.from_numpy(d(path)).to(self.device)  # [N, 2, 4, hl, wl] fp16
        return typicality_map(grid, h, w, self.kx, self.ky).cpu().numpy()

    def load_typicality_norm(self, d: D, path: str) -> np.ndarray:
        w, h = self.load_image(path).size
        grid = torch.from_numpy(d(path)).to(self.device)
        return normalize(pixel_typicality_map(grid, h, w).cpu().numpy())

    def typicality_overlay(self, d: D, path: str, sigma: float = 10.0) -> Image.Image:
        """Typicality-as-alpha composite of the whole image: the normalized
        per-pixel map, sigma-blurred, gates the image toward white where the
        model finds nothing typical — R = 0.05·I + 0.95·(T·I + (1−T)).

        This is the reference's `apply_alpha` figure recipe (utils.py:165-214
        / cluster.py:93-109 load_and_apply_alpha_bbox), reimplemented without
        its hardcoded author-local artifact paths (utils.py:137-163), which
        made the original uninvokable outside the author's machine. The blur
        radius follows scipy gaussian_filter's truncate=4 default."""
        pil = self.load_image(path)
        I = np.asarray(pil, np.float64) / 255.0
        T = self.load_typicality_norm(d, path)  # [0, 1]
        ksize = 2 * int(4.0 * sigma + 0.5) + 1
        T = gaussian_blur(torch.from_numpy(T).to(self.device), float(sigma), ksize).cpu().numpy().astype(np.float64)
        T = T / max(float(T.max()), 1e-12)
        T = T * (T > 0)
        T = T[:, :, None]
        R = 0.05 * I + 0.95 * (T * I + (1.0 - T))
        return Image.fromarray((R * 255.0).astype(np.uint8))

    # ------------------------------------------------------------------
    # patch tables
    # ------------------------------------------------------------------

    def df_D(
        self, country: str, k_per_image: int = 5, seed: int = 42, ascending: bool = False,
        gt_only: bool = False,
    ) -> Tuple[pd.DataFrame, pd.DataFrame]:
        """Per-image top-k non-overlapping boxes + random baseline boxes."""
        d = self.D[country]
        rows, rows_random = [], []
        # one vectorized draw per image (a per-pixel python loop was ~190k
        # host calls per 512px image); still deterministic in `seed` — the
        # stream differs from the old scalar loop, which is fine: the random
        # baseline's exact values are not an interop contract
        rng = np.random.RandomState(seed)
        for path in self.get_seeds(d, country):
            try:
                dm = self.load_typicality(d, path)
                score = -dm if ascending else dm
                boxes, scores = top_patches(score, self.kx, self.ky, k_per_image)
                for (x0, y0, x1, y1), s in zip(boxes, scores):
                    rows.append((path, x0, y0, x1, y1, float(dm[x0, y0]), "real"))
                # random baseline: shuffled candidate order, same suppression
                rand_scores = rng.random_sample(dm.shape).astype(np.float32)
                rboxes, _ = top_patches(rand_scores, self.kx, self.ky, k_per_image)
                for x0, y0, x1, y1 in rboxes:
                    rows_random.append((path, x0, y0, x1, y1, float(dm[x0, y0]), "real"))
            except Exception as ex:  # one corrupt image must not kill the sweep
                print(f"error {ex} @path={path}")
        df = pd.DataFrame(rows, columns=PATCH_COLUMNS)
        df_random = pd.DataFrame(rows_random, columns=PATCH_COLUMNS)
        return df, df_random

    def _cluster_cache(self, country: str) -> str:
        return join(self.cache_path, "clusters", country + ".pkl")

    def patch_tables(self, k_per_image: int = 5) -> Dict[str, Tuple[pd.DataFrame, pd.DataFrame]]:
        out = {}
        for country in self.categories():
            fp = self._cluster_cache(country)
            if os.path.isfile(fp) and not self.recache:
                with open(fp, "rb") as f:
                    out[country] = pickle.load(f)
            else:
                dfs = self.df_D(country, k_per_image=k_per_image)
                atomic_save_pickle(fp, dfs)
                out[country] = dfs
        return out

    def get_top_k(
        self, df: pd.DataFrame, key: str = "D", k: int = 1000, randomize: bool = False,
        ascending: bool = False, filter_by: tuple = (),
    ) -> pd.DataFrame:
        """Top-k patch rows, optionally pre-filtered by image statistics.

        `filter_by` = [("contrast", kwargs), ("gradient", kwargs)] applies the
        reference's patch filters (utils.py:230-252) to each crop before
        ranking. NOTE: the reference's filter branch falls through without a
        return (utils.py:242-251 — the experimental path returns None); here
        filtering composes with the sort+slice, which is the evident intent."""
        k = min(len(df), k)
        if randomize:
            return df.sample(k, random_state=0)
        if filter_by:
            assert all(f in PATCH_FILTERS for f, _ in filter_by), filter_by
            keep = []
            # patch tables hold k_per_image rows per image; memoize the decode
            # + rescale so each source image is opened once, not once per row
            load_image = functools.lru_cache(maxsize=4)(self.load_image)
            for i in range(len(df)):
                row = df.iloc[i]
                pil = load_image(row["seed"]).crop((
                    int(row["y_start"]), int(row["x_start"]),
                    int(row["y_end"]), int(row["x_end"]),
                ))
                arr = np.asarray(pil)
                if all(PATCH_FILTERS[f](arr, **kw) for f, kw in filter_by):
                    keep.append(row)
            df = pd.DataFrame(keep, columns=df.columns)
            k = min(len(df), k)
        return df.sort_values(by=[key], ascending=ascending).reset_index(drop=True).iloc[:k]

    # ------------------------------------------------------------------
    # embeddings
    # ------------------------------------------------------------------

    def init_dift(self):
        if self.dift is None:
            sd = self._dift_sd
            if sd is None:
                assert self.model_path is not None, "DIFT features need a model"
                sd = SD.from_pipeline_dir(self.which, self.model_path, [], dtype=self.dtype, device=self.device)
            self.dift = SDFeaturizer(sd, draws=self.dift_draws)

    def init_clip(self):
        """The CLIP image embedder of the clip modes (reference cluster.py:
        216-229, CLIPModel.get_image_features of the crop through the
        processor): the crop resized and centre-cropped to the tower's
        image_size, CLIP-normalised, the pooled projection L2-normalised.
        The tower runs in float32 on ``self.device``."""
        if self._clip_embed is not None:
            return
        from diffmining_tpu_torch.baselines.clipmining import preprocess, resize_center_crop
        from diffmining_tpu_torch.models.clip import CLIPVisionModel
        from diffmining_tpu_torch.utils.weights import load_clip_dir, load_state

        bundle = self._clip_bundle
        if bundle is None:
            if self.clip_dir is None:
                raise ValueError("the clip feature modes need --clip_dir (a converted CLIPModel checkpoint dir, "
                                 "e.g. clip-vit-base-patch32)")
            bundle = load_clip_dir(self.clip_dir)["vision"]
        model = CLIPVisionModel(bundle["config"])
        load_state(model, bundle["state_dict"])
        model = model.to(self.device, torch.float32).eval()
        size = bundle["config"].image_size

        @torch.no_grad()
        def embed(pil) -> np.ndarray:
            x = torch.from_numpy(preprocess(resize_center_crop(pil.convert("RGB"), size)))
            v = model(x.permute(2, 0, 1)[None].to(self.device))[0][0].float().cpu().numpy()
            return v / max(float(np.linalg.norm(v)), 1e-12)

        self._clip_embed = embed

    @staticmethod
    def parse_feature_which(feature_which: str):
        """'dift-161' / 'clip' / 'clip+dift-161' -> (use_dift, use_clip, t)
        (reference cluster.py:247-253's tag grammar)."""
        use_dift = "dift" in feature_which
        use_clip = "clip" in feature_which
        if not (use_dift or use_clip):
            raise ValueError(
                f"unrecognized feature_which {feature_which!r}: expected "
                "'dift-{t}', 'clip', or 'clip+dift-{t}'"
            )
        t = None
        if use_clip and use_dift:
            t = int(feature_which.split("+")[1].split("-")[1])
        elif use_dift:
            t = int(feature_which.split("-")[1])
        return use_dift, use_clip, t

    def compute_embeddings(
        self, df: pd.DataFrame, c: str, to_add_border: bool = True, feature_which: str = "dift-261"
    ):
        """Per-patch features (reference cluster.py:243-310): DIFT = crop of
        the whole-image feature map (mean, L2-norm); CLIP = the image
        embedding of the cropped patch; clip+dift = [clip | dift]. Cached
        per patch. The rows that need a feature are computed grouped by
        source image, so each image's ensemble runs once however its patches
        rank (the features, and their order in X, are the same either
        way)."""
        use_dift, use_clip, t = self.parse_feature_which(feature_which)
        X, ids, pils, ds, orig_path = [], [], [], [], []
        todo = []
        emb_dir = join(self.cache_path, "embeddings", feature_which)
        os.makedirs(emb_dir, exist_ok=True)
        for i in range(df.shape[0]):
            row = df.iloc[i]
            pil = self.load_image(row["seed"])
            x0, y0, x1, y1 = int(row["x_start"]), int(row["y_start"]), int(row["x_end"]), int(row["y_end"])
            patch = pil.crop((y0, x0, y1, x1))  # PIL crop is (left, upper, right, lower)
            name = os.path.split(row["seed"])[1]
            ext = os.path.splitext(name)[1]
            idd = name.replace(ext, "_") + f"{x0}-{y0}-{x1}-{y1}"
            ids.append(idd)
            ds.append(row["D"])
            orig_path.append(row["seed"])
            pils.append(add_border(patch, "transparent" if row["origin"] == "fake" else "red") if to_add_border else patch)

            pkl_file = join(emb_dir, idd + ".pkl")
            if self.cache_features and os.path.isfile(pkl_file):
                with open(pkl_file, "rb") as f:
                    X.append(pickle.load(f))
            else:
                X.append(None)
                todo.append((row["seed"], i, (x0, y0, x1, y1), pkl_file, patch))
        if todo and use_dift:
            self.init_dift()
        if todo and use_clip:
            self.init_clip()
        for seed, i, box, pkl_file, patch in sorted(todo, key=lambda r: r[0]):
            parts = []
            if use_clip:
                parts.append(self._clip_embed(patch))
            if use_dift:
                arr = array_from_uint8(np.asarray(self.load_image(seed).convert("RGB")))
                parts.append(self.dift.patch_feature(arr, dift_prompt(self.which, c), box, t=t, uid=image_uid(seed)))
            X[i] = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if self.cache_features:
                atomic_save_pickle(pkl_file, X[i])
        return X, ids, pils, ds, orig_path

    # ------------------------------------------------------------------
    # clustering
    # ------------------------------------------------------------------

    def cluster(self, X, ids, pils, ds, real_paths, country=None, num_clusters: int = 8, project: bool = False):
        """KMeans + rank clusters by aggregate typicality
        (reference cluster.py:312-328)."""
        X = np.stack(X, axis=0)
        if project:
            try:
                import umap  # optional CPU post-step (reference cluster.py:315)

                X = umap.UMAP(n_components=5).fit_transform(X)
            except ImportError:
                print("umap not available; clustering raw features")
        km = KMeans(n_clusters=num_clusters, random_state=10, device=str(self.device)).fit(X)
        clusters = defaultdict(list)
        for i, l in enumerate(km.labels_):
            clusters[int(l)].append((pils[i], ds[i], ids[i], X[i], real_paths[i]))
        ranked = []
        for k, vs in clusters.items():
            vs = sorted(vs, key=lambda v: float(np.linalg.norm(v[3] - km.cluster_centers_[k])))
            members = [(a, b, c, e) for a, b, c, d_, e in vs]
            ranked.append((members, self.aggregate(vs)))
        return sorted(ranked, key=lambda kv: kv[1], reverse=True)

    def clustering(
        self, feature_which: str, k_per_image: int = 5, k: int = 1000, num_clusters: int = 32,
        only_gt: bool = True, project: bool = False,
    ):
        """End-to-end mining (reference cluster.py:330-380): patch tables →
        top-k per category → DIFT embeddings → k-means → save member crops."""
        tables = self.patch_tables(k_per_image=k_per_image)
        dfs = {c: self.get_top_k(t[0], k=k) for c, t in tables.items()}
        results = {}
        for country in sorted(self.categories()):
            embs = self.compute_embeddings(dfs[country], c=country, to_add_border=not only_gt, feature_which=feature_which)
            ranked = self.cluster(*embs, country=country, num_clusters=num_clusters, project=project)
            results[country] = ranked
            local_dir = join("images", "clusters", "ranked", feature_which, country)
            parent = join(self.cache_path, local_dir)
            os.makedirs(parent, exist_ok=True)
            for i, (members, _score) in enumerate(ranked):
                for j, (pil, _d, idd, _p) in enumerate(members):
                    pil.save(join(parent, f"{i}-{j}-{num_clusters}_{idd}.png"))
        return results

    def compute_least(self, k_per_image: int = 5) -> Dict[str, pd.DataFrame]:
        """Least-typical patch tables (reference cluster.py:382-396:
        df_D with ascending=True, cached per category)."""
        out = {}
        for country in self.categories():
            fp = join(self.cache_path, "clusters", country + "-gt_least.pkl")
            if os.path.isfile(fp) and not self.recache:
                with open(fp, "rb") as f:
                    out[country], _ = pickle.load(f)
            else:
                dfs = self.df_D(country, k_per_image=k_per_image, ascending=True)
                atomic_save_pickle(fp, dfs)
                out[country] = dfs[0]
        return out

    def plot_top_k(self, k_per_image: int = 5, k: int = 200, overlays: bool = False) -> None:
        """Save the top-k patch crops per category for D / random / D_least
        (reference cluster.py:398-434). With `overlays`, each D crop is also
        saved typicality-as-alpha composited (`alpha-{i}.png`, the filename
        prefix the reference's commented-out alpha path used,
        cluster.py:376-379)."""
        tables = self.patch_tables(k_per_image=k_per_image)
        dfs = {c: self.get_top_k(t[0], k=k) for c, t in tables.items()}
        dfs_random = {c: self.get_top_k(t[1], k=k, randomize=True) for c, t in tables.items()}
        dfs_least = {
            c: self.get_top_k(t, k=k, ascending=True) for c, t in self.compute_least(k_per_image).items()
        }
        for name, dfs_ in zip(["D", "random", "D_least"], [dfs, dfs_random, dfs_least]):
            for c, df in dfs_.items():
                outdir = join(self.cache_path, "images", "topk", name, c)
                os.makedirs(outdir, exist_ok=True)
                # overlay composites are per source image; memoize across the
                # k_per_image rows that share one image
                overlay_fn = (
                    functools.lru_cache(maxsize=4)(
                        lambda seed, _c=c: self.typicality_overlay(self.D[_c], seed)
                    )
                    if overlays and name == "D"
                    else None
                )
                for i in range(df.shape[0]):
                    row = df.iloc[i]
                    x0, y0, x1, y1 = (int(row[cc]) for cc in ["x_start", "y_start", "x_end", "y_end"])
                    pil = self.load_image(row["seed"]).crop((y0, x0, y1, x1))
                    pil.convert("RGBA").save(join(outdir, f"{i}.png"))
                    if overlay_fn is not None:
                        alpha = overlay_fn(row["seed"]).crop((y0, x0, y1, x1))
                        alpha.convert("RGBA").save(join(outdir, f"alpha-{i}.png"))

    # ------------------------------------------------------------------
    # whole-image ranking + figures
    # ------------------------------------------------------------------

    def rank_images(self, country: str, gt_only: bool = False) -> List[Tuple[str, float]]:
        d = self.D[country]
        out = []
        for path in self.get_seeds(d, country):
            try:
                w, h = self.load_image(path).size
                dm = pixel_typicality_map(torch.from_numpy(d(path)).to(self.device), h, w).cpu().numpy()
                out.append((path, float(np.mean(dm))))
            except Exception as ex:
                print("error", ex, "@path=", path)
        return out

    def extract_top_k_images(self, output_dir: str, k: int = 5):
        for country in self.categories():
            os.makedirs(join(output_dir, "ordered"), exist_ok=True)
            data = self.rank_images(country, gt_only=True)
            data_min = sorted(data, key=lambda x: x[1])
            data_max = sorted(data, key=lambda x: x[1], reverse=True)
            shuffled = list(data)
            random.Random(42).shuffle(shuffled)
            for name, data_ in zip(["D_least", "D", "random"], [data_min, data_max, shuffled]):
                pils = [self.load_image(p).convert("RGBA") for p, _ in data_[:k]]
                if pils:
                    hcat_margin(pils).save(join(output_dir, "ordered", f"{country}_{name}.png"))

    def make_figure(
        self, figure_path: str, hard_limit: int = 6, top_k: int = 5, min_im: int = 5,
        feature_which: Optional[str] = None, grid_sep_x: int = 2, grid_sep_y: int = 2,
    ):
        """Cluster grids from saved member crops (reference cluster.py:439-510)."""
        dirr = join(self.cache_path, "images", "clusters")
        if not os.path.isdir(dirr):
            return
        for which in os.listdir(dirr):
            for feature_type in os.listdir(join(dirr, which)):
                if feature_which not in (None, "all", feature_type):
                    continue
                for t in os.listdir(join(dirr, which, feature_type)):
                    parent = join(dirr, which, feature_type, t)
                    group = defaultdict(list)
                    for image_path in os.listdir(parent):
                        cluster_id, idx = image_path.split("-")[:2]
                        group[int(cluster_id)].append((int(idx), join(parent, image_path)))
                    grid_rows = []
                    for cid in sorted(group):
                        if len(grid_rows) == top_k:
                            break
                        members = sorted(group[cid])
                        if len(members) < min_im:
                            continue
                        grid_rows.append([Image.open(p).convert("RGB") for _, p in members[:hard_limit]])
                    if grid_rows:
                        os.makedirs(join(figure_path, "clusters"), exist_ok=True)
                        make_grid(grid_rows, grid_sep_x, grid_sep_y).save(
                            join(figure_path, "clusters", f"{t}_{which}.png")
                        )

    def make_topk_figure(self, figure_path: str, max_elems: int = 7) -> None:
        """hcat strips of the saved top-k crops, filtered for near-black/white
        (reference cluster.py:497-510)."""
        root = join(self.cache_path, "images", "topk")
        if not os.path.isdir(root):
            return
        for name in os.listdir(root):
            for c in os.listdir(join(root, name)):
                pils = []
                # skip the alpha-{i}.png overlay companions (saved by
                # plot_top_k(overlays=True)) — the strip shows the raw crops
                files = [f for f in os.listdir(join(root, name, c)) if not f.startswith("alpha-")]
                files = sorted(files, key=lambda x: int(x.split(".")[0]))
                for file in files:
                    pil = Image.open(join(root, name, c, file))
                    if filter_patch(np.asarray(pil.convert("RGB"))):
                        pils.append(pil)
                        if len(pils) == max_elems:
                            break
                if pils:
                    os.makedirs(join(figure_path, "topk", c), exist_ok=True)
                    hcat_margin(pils).save(join(figure_path, "topk", c, f"{name}.png"))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Mining/clustering on the GPU (reference cluster.py CLI)")
    parser.add_argument("-d", "--dataset_path", required=True)
    parser.add_argument("-c", "--cache_path", required=True)
    parser.add_argument("-t", "--typicality_path", required=True)
    parser.add_argument("-m", "--model_path", default=None)
    parser.add_argument("-w", "--which", required=True, choices=["ftt", "geo", "cars", "places"])
    parser.add_argument("--recache", action="store_true")
    parser.add_argument("--cluster", action="store_true")
    parser.add_argument("--topk", action="store_true")
    parser.add_argument(
        "--overlays", action="store_true",
        help="with --topk, also save typicality-as-alpha composites of the "
        "top-D crops (the reference's apply_alpha figures)",
    )
    parser.add_argument("--umap", action="store_true")
    parser.add_argument(
        "--feature_which", type=str, default="dift-161",
        help="dift-{t} | clip | clip+dift-{t} (reference cluster.py:247-253)",
    )
    parser.add_argument(
        "--clip_dir", type=str, default=None,
        help="converted CLIPModel dir for the clip feature modes (the reference uses "
        "openai/clip-vit-base-patch32)",
    )
    parser.add_argument("--figure_path", type=str, default=None)
    parser.add_argument("--top_full_images", action="store_true")
    parser.add_argument("--num_images", type=int, default=None)
    parser.add_argument("--num_clusters", type=int, default=32)
    parser.add_argument("--k", type=int, default=64)
    parser.add_argument("--aggregate", type=str, default="median", choices=["mean", "median"])
    parser.add_argument("--not_cache_features", action="store_false", dest="cache_features")
    parser.add_argument("-s", "--seed", type=int, default=42,
                        help="accepted for reference CLI parity (reference "
                        "cluster.py:572 parses it and never uses it)")
    parser.add_argument("--figures_only", action="store_true",
                        help="skip topk/clustering compute; only regenerate "
                        "figures from the cache (reference cluster.py:597)")
    parser.add_argument("--max_row", type=int, default=6)
    parser.add_argument("--top_k_figure", type=int, default=5)
    parser.add_argument("--min_row", type=int, default=5)
    parser.add_argument("--grid_sep_x", type=int, default=2)
    parser.add_argument("--grid_sep_y", type=int, default=4)
    parser.add_argument(
        "--native_res", action="store_true",
        help="mine artifacts swept with `typicality --native_res` (skips the "
        "cars/places domain downscale so boxes match the stored grids)",
    )
    parser.add_argument(
        "--mesh_dp", type=int, default=None,
        help="shard the DIFT ensemble axis over a device mesh (multi-GPU: not ported yet, ROADMAP A12)",
    )
    parser.add_argument("--dtype", type=str, default="bf16", choices=sorted(DTYPES),
                        help="DIFT compute dtype: bf16 (default), or fp32 for validation runs; both "
                             "run on the GPU (float32 flash and fused-norm kernels) and with --device cpu")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.mesh_dp is not None:
        raise SystemExit("--mesh_dp: multi-GPU mining is not ported yet (ROADMAP A12)")

    cluster = Cluster(
        args.which, args.typicality_path, args.dataset_path, args.cache_path, args.recache,
        model_path=args.model_path, aggregate=args.aggregate, kx=args.k, ky=args.k,
        cache_features=args.cache_features, clip_dir=args.clip_dir,
        native_res=args.native_res, device=args.device, dtype=DTYPES[args.dtype],
    )
    if not args.figures_only:
        if args.topk:
            cluster.plot_top_k(
                k_per_image=5, k=(50 if args.num_images is None else args.num_images),
                overlays=args.overlays,
            )
        if args.cluster:
            cluster.clustering(
                feature_which=args.feature_which, k=(1000 if args.num_images is None else args.num_images),
                num_clusters=args.num_clusters, project=args.umap,
            )
    if args.figure_path is not None:
        if args.top_full_images:
            cluster.extract_top_k_images(args.figure_path)
        else:
            cluster.make_figure(
                args.figure_path, feature_which=args.feature_which,
                hard_limit=args.max_row, top_k=args.top_k_figure, min_im=args.min_row,
                grid_sep_x=args.grid_sep_x, grid_sep_y=args.grid_sep_y,
            )
            if args.topk:
                cluster.make_topk_figure(args.figure_path)


if __name__ == "__main__":
    main()
