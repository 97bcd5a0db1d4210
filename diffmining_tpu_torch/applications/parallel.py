"""Parallel-dataset pipeline: typicality and mining over PnP's translations
(counterpart of diffmining_tpu/applications/parallel.py; reference
applications/parallel-dataset/compute.py and cluster.py).

It runs on the files PnP writes (applications/pnp.py), laid out as the geo
protocol reads them: ``{root}/{source country}/gt--{country}__{id}`` and one
``{target}__{id}`` translation per other country.

  * typicality (``ParallelTypicality``): the sweep, specialised to geo's raw
    "{c}" prompts, over BOTH the ground-truth and the translated files;
  * mining (``ParallelCluster.df_PD``): for each source image, the score maps
    of all its translations are median-stacked into one map; the boxes are
    picked on that map and carry each country's D and path;
  * embeddings: the DIFT features of the SAME box in every translation,
    concatenated country-major ([clip | dift] under clip+dift, the CLIP
    parts through ``Cluster.init_clip``);
  * compress: a reduction to 32 dimensions per country group, hstacked
    (UMAP when it imports, numpy PCA otherwise);
  * clusters of visual elements ACROSS countries, ranked by the aggregate D.

The reference's quirk is kept behind ``faithful_centers=True``: the cluster
"center" that orders the members is the FARTHEST point of the reduced space
(np.argmax, reference cluster.py:281). The score maps and DIFT run on
``device`` (the card unless the caller asks for the CPU).

With a mesh (``--mesh_dp`` under torchrun, one process a GPU) the compute
stage is typicality's sweep over dp and the cluster stage's DIFT ensemble
shards over dp; rank 0 alone writes the shared files, and every rank
decides what is cached before any rank writes.

    python -m diffmining_tpu_torch parallel -i PARALLEL -t TREE -c CACHE -m PIPELINE_DIR --cluster
    torchrun --nproc_per_node 2 -m diffmining_tpu_torch parallel ... --cluster --mesh_dp 2
"""
from __future__ import annotations

import argparse
import os
import pickle
import random
from collections import defaultdict
from os.path import join
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch
from PIL import Image

from diffmining_tpu_torch.ops.kmeans import KMeans
from diffmining_tpu_torch.ops.pool import top_patches, typicality_map
from diffmining_tpu_torch.parallel.mesh import Mesh, cli_mesh, destroy, host_barrier, is_writer
from diffmining_tpu_torch.typicality.cluster import Cluster, mean_agg, median_agg
from diffmining_tpu_torch.typicality.compute import DTYPES, SD, D, Typicality
from diffmining_tpu_torch.typicality.dift import SDFeaturizer
from diffmining_tpu_torch.utils.artifacts import atomic_save_pickle
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.figures import add_border, hcat, vcat
from diffmining_tpu_torch.utils.images import array_from_uint8, image_uid

__all__ = ["ParallelTypicality", "ParallelCluster", "median_agg", "mean_agg", "main"]


class ParallelTypicality(Typicality):
    """Typicality over the translated dataset: every file, ground truth and
    translation, under its own country's condition (reference
    parallel-dataset/compute.py:186-263)."""

    def __init__(self, model_path, dataset_path, typicality_path, sd=None, N=100, t_min=0.0, t_max=1.0,
                 batch_images=8, dtype=torch.bfloat16, device="cuda", draws: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__(
            "geo", model_path, dataset_path, typicality_path, t_min=t_min, t_max=t_max, sd=sd, N=N,
            batch_images=batch_images, dtype=dtype, device=device, draws=draws, mesh=mesh,
        )

    def get_seeds_(self, c: str) -> List[str]:
        # both ground-truth and translated files, unlike the base pipeline
        return [p for p, _is_gt in self.country_path[c]]


class ParallelCluster:
    def __init__(
        self,
        typicality_path: str,
        dataset_path: str,
        cache_path: str,
        recache: bool = False,
        model_path: Optional[str] = None,
        aggregate: str = "median",
        kx: int = 64,
        ky: int = 64,
        sd: Optional[SD] = None,
        dift_sd: Optional[SD] = None,
        faithful_centers: bool = True,
        clip_dir: Optional[str] = None,
        clip_bundle: Optional[dict] = None,
        mesh: Optional[Mesh] = None,
        device="cuda",
        dtype=torch.bfloat16,
        dift_draws: Optional[Callable] = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.mesh = mesh  # the DIFT ensemble over dp; rank 0 writes
        self.typ = ParallelTypicality(None, dataset_path, typicality_path, sd=sd, device=device)
        self.D = self.typ.D
        self.parallel = self.typ.parallel
        self.countries = sorted(self.typ.parent.keys())
        self.cache_path = cache_path
        self.recache = recache
        self.kx, self.ky = kx, ky
        self.model_path = model_path
        self.aggregate = median_agg if aggregate == "median" else mean_agg
        self.faithful_centers = faithful_centers
        self._dift_sd = dift_sd
        self.dift_draws = dift_draws
        self.dift: Optional[SDFeaturizer] = None
        # clip / clip+dift-* modes (reference parallel cluster.py:146-190):
        # the CLIP embeddings of the per-country crops, flattened
        self.clip_dir = clip_dir
        self._clip_bundle = clip_bundle
        self._clip_embed = None

    def init_clip(self):
        Cluster.init_clip(self)  # the same lazy embedder over the same fields

    # ------------------------------------------------------------------

    def load_typicality(self, d: D, path: str) -> np.ndarray:
        """The patch-score map of one file's artifact, on the device."""
        grid, (w, h) = d(path), Image.open(path).size
        return self._score_map(grid, h, w)

    def _score_map(self, grid: np.ndarray, h: int, w: int) -> np.ndarray:
        return typicality_map(torch.from_numpy(grid).to(self.device), h, w, self.kx, self.ky).cpu().numpy()

    def df_PD(self, k_per_image: int = 5, seed: int = 42, ascending: bool = False):
        """Median-stack the translations of each source image and mine boxes
        on the median map (reference cluster.py:224-251); the random
        baseline's boxes from ``random.Random(seed)``, one draw a map
        element, as JAX draws them. A group whose artifacts or images
        cannot be read is reported and skipped, as in the reference; any
        other error (the device's) raises."""
        columns = (
            ["x_start", "y_start", "x_end", "y_end", "origin", "D"]
            + self.countries
            + ["path_" + c for c in self.countries]
        )
        rows, rows_random = [], []
        rng = random.Random(seed)
        for origin in self.countries:
            for group in self.parallel[origin]:
                if not all(self.D[c].exists(p) for p, c in group):
                    continue
                pths = {c: p for p, c in group}
                if set(pths) != set(self.countries):
                    continue
                try:
                    loaded = {c: (self.D[c](p), Image.open(p).size) for p, c in group}
                except (OSError, ValueError) as ex:  # a missing or unreadable file
                    print("error", ex, "@paths=", group)
                    continue
                ds = {c: self._score_map(grid, h, w) for c, (grid, (w, h)) in loaded.items()}
                dm = np.median(np.stack([ds[c] for c in self.countries]), axis=0)
                boxes, _ = top_patches(dm if not ascending else -dm, self.kx, self.ky, k_per_image)
                rnd = np.asarray([rng.random() for _ in range(dm.size)], np.float32).reshape(dm.shape)
                rboxes, _ = top_patches(rnd, self.kx, self.ky, k_per_image)
                for bx, is_random in ((boxes, False), (rboxes, True)):
                    for (x0, y0, x1, y1) in bx:
                        row = (
                            (int(x0), int(y0), int(x1), int(y1), origin, float(dm[x0, y0]))
                            + tuple(float(ds[c][x0, y0]) for c in self.countries)
                            + tuple(pths[c] for c in self.countries)
                        )
                        (rows_random if is_random else rows).append(row)
        return pd.DataFrame(rows, columns=columns), pd.DataFrame(rows_random, columns=columns)

    # ------------------------------------------------------------------

    def init_dift(self):
        if self.dift is None:
            sd = self._dift_sd
            if sd is None:
                assert self.model_path is not None, "DIFT features need a model"
                sd = SD.from_pipeline_dir("geo", self.model_path, [], dtype=self.dtype, device=self.device)
            self.dift = SDFeaturizer(sd, mesh=self.mesh, draws=self.dift_draws)

    def _pkl(self, sub: str, idd: str) -> str:
        return join(self.cache_path, "embeddings", sub, f"{idd}.pkl")

    def _cached(self, sub: str, idd: str, fn, hit: Optional[bool] = None):
        """The embedding pickle of ``idd``, or ``fn()``, which rank 0 then
        writes. ``hit`` is whether the pickle was there when every rank
        listed the cache (``compute_embeddings``); None: look now."""
        pkl_file = self._pkl(sub, idd)
        if os.path.isfile(pkl_file) if hit is None else hit:
            with open(pkl_file, "rb") as f:
                return pickle.load(f)
        out = fn()
        if is_writer(self.mesh):
            atomic_save_pickle(pkl_file, out)
        return out

    def embed_batch(self, images: Sequence[Image.Image], t: Optional[int], idd: str, bbox,
                    use_dift: bool = True, use_clip: bool = False, hits: Optional[dict] = None) -> np.ndarray:
        """The per-country features of the same box in every translation,
        concatenated (reference cluster.py:152-190); bbox = (y0, x0, y1, x1).
        DIFT: the per-country patch features; CLIP: the per-country crop
        embeddings (each L2-normalised); clip+dift: [clip | dift]. ``hits``:
        the cache listing of ``compute_embeddings``, {(sub, idd): cached}."""
        y0, x0, y1, x1 = bbox
        hits = hits or {}
        parts = []
        if use_clip:
            def clip_feats():
                self.init_clip()
                return np.concatenate([self._clip_embed(pil.crop((y0, x0, y1, x1))) for pil in images])

            parts.append(self._cached("clip", idd, clip_feats, hits.get(("clip", idd))))
        if use_dift:
            def dift_feats():
                self.init_dift()
                return np.concatenate([
                    self.dift.patch_feature(array_from_uint8(np.asarray(pil)), f"{c}", (x0, y0, x1, y1), t=t,
                                            uid=image_uid(idd + c))
                    for c, pil in zip(self.countries, images)
                ])

            parts.append(self._cached(f"dift-{t}", idd, dift_feats, hits.get((f"dift-{t}", idd))))
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    @staticmethod
    def _box(row) -> Tuple[int, int, int, int]:
        return tuple(int(row[c]) for c in ["x_start", "y_start", "x_end", "y_end"])

    def compute_embeddings(self, df: pd.DataFrame, feature_which: str = "dift-261"):
        use_dift, use_clip, t = Cluster.parse_feature_which(feature_which)
        X, ids, pils, ds, origins = [], [], [], [], []
        for i in range(df.shape[0]):
            row = df.iloc[i]
            x0, y0, x1, y1 = self._box(row)
            ids.append(os.path.splitext(os.path.split(row["path_" + row["origin"]])[1])[0] + f"_{x0}-{y0}-{x1}-{y1}")
        subs = (["clip"] if use_clip else []) + ([f"dift-{t}"] if use_dift else [])
        hits = {(sub, idd): os.path.isfile(self._pkl(sub, idd)) for sub in subs for idd in ids}
        # every rank has listed the cache before rank 0 writes: the ranks
        # send the same boxes, in the same order, through the DIFT all-reduce
        host_barrier("parallel_embeddings")
        for i, idd in enumerate(ids):
            row = df.iloc[i]
            ds.append(row["D"])
            origins.append(row["origin"])
            images = [Image.open(row["path_" + c]).convert("RGB") for c in self.countries]
            x0, y0, x1, y1 = self._box(row)
            X.append(self.embed_batch(images, t, idd, (y0, x0, y1, x1), use_dift=use_dift, use_clip=use_clip,
                                      hits=hits))
            bordered = [
                add_border(img.crop((y0, x0, y1, x1)), "red" if c == row["origin"] else "transparent")
                for c, img in zip(self.countries, images)
            ]
            pils.append(hcat(bordered))
        return X, ids, pils, ds, origins

    # ------------------------------------------------------------------

    def compress(self, X, num_components: int = 32, n_neighbors: int = 15) -> np.ndarray:
        """A reduction per country group, then hstack (reference
        cluster.py:253-266): UMAP if it imports, numpy PCA otherwise."""
        X = np.stack(X).astype(np.float32)
        emb_size = X.shape[1]
        group = emb_size // len(self.countries)
        num_components = min(num_components, max(2, len(X) - 1))
        parts = []
        for i in range(0, emb_size, group):
            block = X[:, i:i + group]
            try:
                import umap

                parts.append(umap.UMAP(n_components=num_components, n_neighbors=n_neighbors).fit_transform(block))
            except ImportError:
                centered = block - block.mean(axis=0)
                _u, _s, vt = np.linalg.svd(centered, full_matrices=False)
                parts.append(centered @ vt[:num_components].T)
        return np.hstack(parts)

    def cluster(self, X, ids, pils, ds, origins, num_clusters: int = 32, num_components: int = 32):
        Xr = self.compress(X, num_components=num_components)
        km = KMeans(n_clusters=num_clusters, random_state=10, device=str(self.device)).fit(Xr)
        clusters = defaultdict(list)
        for i, l in enumerate(km.labels_):
            clusters[int(l)].append((pils[i], ds[i], ids[i], Xr[i], origins[i]))
        centers = []
        for cc in km.cluster_centers_:
            dist = np.linalg.norm(Xr - cc[None], axis=1)
            # the reference takes argmax (the farthest point), kept behind the flag
            idx = int(np.argmax(dist) if self.faithful_centers else np.argmin(dist))
            centers.append(Xr[idx])
        ranked = []
        for k, vs in clusters.items():
            vs = sorted(vs, key=lambda v: float(np.linalg.norm(v[3] - centers[k])))
            ranked.append(([(a, b, c, e) for a, b, c, d_, e in vs], self.aggregate(vs)))
        return sorted(ranked, key=lambda kv: kv[1], reverse=True)

    def clustering(self, feature_which: str = "dift-161", k_per_image: int = 5, k: int = 1000,
                   num_clusters: int = 32, num_components: int = 32):
        fp = join(self.cache_path, "clusters", "all.pkl")
        cached = os.path.isfile(fp) and not self.recache
        host_barrier("parallel_tables")  # every rank has decided before rank 0 writes
        if cached:
            with open(fp, "rb") as f:
                df, _df_random = pickle.load(f)
        else:
            df, _df_random = dfs = self.df_PD(k_per_image=k_per_image)
            if is_writer(self.mesh):
                atomic_save_pickle(fp, dfs)
        df = df.sort_values(by=["D"], ascending=False).reset_index(drop=True).iloc[:k]
        embs = self.compute_embeddings(df, feature_which=feature_which)
        if not embs[0]:
            return []
        num_clusters = min(num_clusters, len(embs[0]))
        clusters = self.cluster(*embs, num_clusters=num_clusters, num_components=num_components)
        if not is_writer(self.mesh):
            return clusters
        parent = join(self.cache_path, "images", "clusters", str(k), str(num_clusters), "ranked", feature_which)
        os.makedirs(parent, exist_ok=True)
        for i, (members, _score) in enumerate(clusters):
            for j, (pil, _d, idd, _o) in enumerate(members):
                pil.save(join(parent, f"{i}-{j}-{num_clusters}_{idd}.png"))
        return clusters

    def make_figure(self, figure_path: str, k: int, num_clusters: int, hard_limit: int = 6, top_k: int = 5,
                    min_im: int = 5, feature_which: str = "dift-161"):
        if not is_writer(self.mesh):
            return
        dirr = join(self.cache_path, "images", "clusters", str(k), str(num_clusters), "ranked", feature_which)
        if not os.path.isdir(dirr):
            return
        group = defaultdict(list)
        for image_path in os.listdir(dirr):
            cluster_id, idx = image_path.split("-")[:2]
            group[int(cluster_id)].append((int(idx), join(dirr, image_path)))
        parent = join(figure_path, "clusters", "ranked", feature_which, str(num_clusters))
        os.makedirs(parent, exist_ok=True)
        count = 0
        for cid in sorted(group):
            if count == top_k:
                break
            members = sorted(group[cid])
            if len(members) < min_im:
                continue
            vcat([Image.open(p).convert("RGB") for _, p in members[:hard_limit]], vertical_spacing=1).save(
                join(parent, f"{cid}__hard_limit_{hard_limit}__top_k_{top_k}__min_im_{min_im}.png")
            )
            count += 1


def main(argv=None):
    p = argparse.ArgumentParser(description="parallel-dataset mining on the GPU (reference parallel cluster.py CLI)")
    p.add_argument("-d", "-i", "--dataset_path", required=True)
    p.add_argument("-t", "--typicality_path", required=True)
    p.add_argument("-c", "--cache_path", required=True)
    p.add_argument("-m", "--model_path", default=None)
    p.add_argument("--recache", action="store_true")
    p.add_argument("--cluster", action="store_true")
    p.add_argument("--compute", action="store_true")
    p.add_argument("--make_submission", action="store_true")
    p.add_argument("--submission_path", default=None)
    p.add_argument("--N", type=int, default=100)
    p.add_argument("--t_min", type=float, default=0.0)
    p.add_argument("--t_max", type=float, default=1.0)
    # reference-CLI parity (one CLI serves the reference's compute.py and
    # cluster.py): accepted and inert where they are dead upstream
    # (--countries, --seed, --cache_features) or inverted by the explicit
    # --compute (--dont_compute)
    p.add_argument("--dont_compute", action="store_true",
                   help="suppress the compute stage (it is opt-in via --compute)")
    p.add_argument("--countries", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cache_features", action="store_true")
    p.add_argument("--figures_only", action="store_true", help="skip clustering compute; only regenerate figures")
    p.add_argument("--max_row", type=int, default=6)
    p.add_argument("--min_row", type=int, default=5)
    p.add_argument("--top_k_figure", type=int, default=5)
    p.add_argument("--topk", action="store_true",
                   help="accepted for parity; the reference's parallel --topk path calls a method its "
                   "Cluster does not define (cluster.py:395) — ignored here")
    p.add_argument("--top_full_images", action="store_true", help="accepted for parity; ignored like --topk")
    p.add_argument("--split_id", type=int, default=0)
    p.add_argument("--sub_split", type=int, default=1)
    p.add_argument("--feature_which", type=str, default="dift-161")
    p.add_argument("--figure_path", type=str, default=None)
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--num_clusters", type=int, default=32)
    p.add_argument("--num_components", type=int, default=32)
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--aggregate", default="median", choices=["mean", "median"])
    p.add_argument("--clip_dir", type=str, default=None,
                   help="converted CLIPModel dir for the clip feature modes "
                   "(the reference's default is models/clip-vit-base-patch32)")
    p.add_argument("--mesh_dp", type=int, default=None,
                   help="shard the sweep batch and the DIFT ensemble over this many processes, one GPU each "
                   "(default under torchrun: every rank); above 1, launch under torchrun --nproc_per_node MESH_DP")
    p.add_argument("--dtype", type=str, default="bf16", choices=sorted(DTYPES),
                   help="compute dtype: bf16 (default), or fp32 for validation runs; both run on the GPU "
                   "(float32 flash kernels) and with --device cpu")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    try:
        _run(args)
    finally:
        destroy()


def _run(args) -> None:
    mesh = cli_mesh("parallel", args.mesh_dp, args.device)
    if args.compute or args.make_submission:
        typ = ParallelTypicality(args.model_path, args.dataset_path, args.typicality_path, N=args.N,
                                 t_min=args.t_min, t_max=args.t_max, dtype=DTYPES[args.dtype], device=args.device,
                                 mesh=mesh)
        if args.make_submission:
            # one writer for the shard files, then a barrier so no rank reads a half-written one
            if is_writer(mesh):
                typ.make_submission(args.dataset_path, args.submission_path, sub_split=args.sub_split)
            host_barrier("parallel_submission")
        if args.compute and not args.dont_compute:
            typ.compute_submission(join(args.submission_path, f"{args.split_id}.txt"))
        return

    k = 10000 if args.num_images is None else args.num_images
    cl = ParallelCluster(
        args.typicality_path, args.dataset_path, args.cache_path, args.recache,
        model_path=args.model_path, aggregate=args.aggregate, kx=args.k, ky=args.k,
        clip_dir=args.clip_dir, mesh=mesh, device=args.device, dtype=DTYPES[args.dtype],
    )
    if args.cluster and not args.figures_only:
        cl.clustering(args.feature_which, k=k, num_clusters=args.num_clusters, num_components=args.num_components)
    if args.figure_path:
        cl.make_figure(args.figure_path, k=k, num_clusters=args.num_clusters, feature_which=args.feature_which,
                       hard_limit=args.max_row, top_k=args.top_k_figure, min_im=args.min_row)


if __name__ == "__main__":
    main()
