"""The Doersch-2012 ("What makes Paris look like Paris") baseline in PyTorch
(counterpart of diffmining_tpu/baselines/doersch.py).

The same algorithm and file protocols as the JAX package:

  * HOG(31)+LAB 64×64 patch features on an 8-px grid, L2-normalised, cached
    per image as fp16 .npy and sharded into .safetensors files of same-shape
    feature maps (``FeatureStore``: the same file names, keys and format, so
    a cache built by either package is read by the other; written and read
    with the port's own safetensors writer and reader);
  * detector init: random high-contrast patches, ranked by top-20 purity
    with IoU > 0.3 neighbour dedup;
  * iterative training: 3 folds × (dense search positives → random negatives
    → linear SVM C = 0.1 with hard-negative mining), the detector chunk
    solved together (``DIFFMINING_DOERSCH_BATCH_SVM=0`` keeps the
    per-detector path);
  * the final top-32 detectors × top-7 patches grid.

The device work is dense: the dense search is one [K, C] x [B·P, C]ᵀ
product a shard block with the max and argmax over positions, and the SVM
is ops/svm.py. It runs on ``device``, the card unless the caller asks for
the CPU; the host merges per-block top-k lists as the JAX package does. A
fold's masked search multiplies the scores by the mask as JAX does, so a
masked position scores 0 and can win where every open score is negative.

With a mesh (``--mesh_dp`` under torchrun, one process a GPU) the dense
search shards the detector axis over dp, padded to a multiple of dp with
the last detector as JAX pads it (doersch.py:183-240): a rank searches its
K/dp detectors and ``all_gather_rows`` hands every rank every detector's
best score and position, so every rank walks the same heaps. The SVM
training stays replicated, as in JAX. Rank 0 alone writes the HOG cache,
the shards, the splits and the detectors, behind a barrier.

    torchrun --nproc_per_node 2 -m diffmining_tpu_torch doersch ... --mesh_dp 2
"""
from __future__ import annotations

import argparse
import heapq
import json
import math
import os
import pickle
import random
from collections import defaultdict
from os.path import join
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from diffmining_tpu_torch.ops.hog import hoglab_features, normalize_features
from diffmining_tpu_torch.ops.svm import fit_linear_svm_batch, train_svm
from diffmining_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    cli_mesh,
    collective_rows,
    destroy,
    host_barrier,
    is_writer,
    pad_to_multiple,
)
from diffmining_tpu_torch.utils.artifacts import atomic_save_pickle
from diffmining_tpu_torch.typicality.templates import get_decade
from diffmining_tpu_torch.utils.device import resolve_device
from diffmining_tpu_torch.utils.figures import add_border, hcat, vcat
from diffmining_tpu_torch.utils.weights import read_safetensors, write_safetensors


def iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1)


def patch_has_contrast(patch: Image.Image, threshold: int = 50) -> bool:
    """The init-patch contrast gate: the 1-99 percentile spread of the
    L-grayscale crop above 0.15 (``threshold`` kept for the CLI, unused as
    in the reference)."""
    arr = np.asarray(patch.convert("L"), dtype=np.float64) / 255.0
    lo, hi = np.percentile(arr, [1, 99])
    return (hi - lo) > 0.15


def search_block(feats: torch.Tensor, ws: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """feats [B, P, C] fp32, ws [K, C] (and the fold mask [B, P]) -> (best
    score [K, B], its position [K, B]): one product, then the max and the
    first argmax over positions."""
    scores = torch.einsum("bpc,kc->kbp", feats, ws)
    if mask is not None:
        scores = scores * mask[None]
    return scores.amax(dim=-1), scores.argmax(dim=-1)


class FeatureStore:
    """Per-image fp16 .npy cache plus sharded .safetensors blocks of
    same-shape feature maps, keyed by the ';;'-joined image paths. With a
    mesh, rank 0 builds and writes both and the other ranks read them."""

    def __init__(self, cache_path: str, shard_path: str, device="cuda", mesh: Optional[Mesh] = None):
        self.cache_path = cache_path
        self.shard_path = shard_path
        self.device = device
        self.mesh = mesh
        os.makedirs(cache_path, exist_ok=True)

    def image_features(self, path: str) -> np.ndarray:
        key = os.path.abspath(path).replace("/", "_")
        fpath = join(self.cache_path, key + ".npy")
        if os.path.isfile(fpath):
            feats = np.load(fpath)
        else:
            img = np.asarray(Image.open(path).convert("RGB"))
            feats = hoglab_features(img, device=self.device).astype(np.float16)
            if is_writer(self.mesh):
                np.save(fpath, feats)
        return normalize_features(feats.astype(np.float32))

    def build_shards(self, paths: Sequence[str], tag: str, num_splits: int = 4, batch_size: int = 16) -> List[str]:
        """The shard files of ``paths`` under ``tag``, listed in its manifest:
        rank 0 builds them if the manifest is missing, and every rank reads
        the manifest after a barrier."""
        manifest = join(self.shard_path, tag, f"{tag}_paths.json")
        if is_writer(self.mesh) and not os.path.isfile(manifest):
            self._write_shards(paths, tag, num_splits, batch_size)
        host_barrier("doersch_shards")
        with open(manifest) as f:
            return json.load(f)

    def _write_shards(self, paths: Sequence[str], tag: str, num_splits: int, batch_size: int) -> None:
        shard_dir = join(self.shard_path, tag)
        manifest = join(shard_dir, f"{tag}_paths.json")
        os.makedirs(shard_dir, exist_ok=True)
        by_shape: Dict[Tuple[int, int], List[str]] = defaultdict(list)
        for p in paths:
            by_shape[self.image_features(p).shape[:2]].append(p)
        out_paths, tensors, idx = [], {}, 0
        n_batches = sum(math.ceil(len(v) / batch_size) for v in by_shape.values())
        per_split = max(1, n_batches // max(num_splits, 1))
        for ps in by_shape.values():
            for i in range(0, len(ps), batch_size):
                chunk = ps[i:i + batch_size]
                tensors[";;".join(chunk)] = np.stack([self.image_features(p) for p in chunk]).astype(np.float16)
                if len(tensors) >= per_split:
                    fp = join(shard_dir, f"{idx}.safetensors")
                    write_safetensors(fp, tensors)
                    out_paths.append(fp)
                    tensors, idx = {}, idx + 1
        if tensors:
            fp = join(shard_dir, f"{idx}.safetensors")
            write_safetensors(fp, tensors)
            out_paths.append(fp)
        with open(manifest, "w") as f:
            json.dump(out_paths, f)


def load_shard(path: str) -> Dict[str, np.ndarray]:
    """One shard's blocks in key order (the order the safetensors package
    hands them out in)."""
    tensors = read_safetensors(path)
    return {k: tensors[k] for k in sorted(tensors)}


def make_bbox(i: int, dims: Tuple[int, int]) -> Tuple[int, int]:
    a, b = np.unravel_index(i, dims)
    return int(a) * 8, int(b) * 8


def _prefetch_shards(shard_paths: Sequence[str]):
    """Yield (path_id, tensors) with a one-deep background loader: shard N+1
    is read from disk while shard N's products run on the device."""
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=1)
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put, so an abandoned consumer does not leave this thread
        # blocked holding shard arrays
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def producer():
        try:
            for path_id, sp in enumerate(shard_paths):
                if stop.is_set() or not _put((path_id, load_shard(sp))):
                    return
            _put(None)
        except BaseException as e:  # surface loader errors in the consumer
            _put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def fold_mask(path_id: int, batch: int, positions: int, fold: Tuple[int, int]) -> np.ndarray:
    """[B, P] float32: per image, the first fold[0]·P // fold[1] positions of
    a permutation drawn from RandomState(path_id), as the JAX package draws
    them."""
    rng = np.random.RandomState(path_id)
    mask = np.zeros((batch, positions), np.float32)
    for b in range(batch):
        mask[b, rng.permutation(positions)[: (fold[0] * positions) // fold[1]]] = 1.0
    return mask


def dense_search(
    ws: np.ndarray,
    shard_paths: Sequence[str],
    top_k: int = 50,
    fold: Optional[Tuple[int, int]] = None,
    ret_ws: bool = False,
    only_pos: bool = False,
    mesh=None,
    device="cuda",
) -> List[List[tuple]]:
    """For each detector, the top_k (score, bbox, path[, feature]) over all
    images; ``fold`` masks a deterministic random subset of grid positions
    per shard. With a mesh, this rank searches its share of the detectors
    (K padded to a multiple of dp by repeating the last one) and the ranks
    gather every detector's best score and position."""
    dev = resolve_device(device)
    K = ws.shape[0]
    ws = np.asarray(ws, np.float32)
    pad = pad_to_multiple(K, 1 if mesh is None else mesh.dp) - K
    if pad:
        ws = np.concatenate([ws, np.repeat(ws[-1:], pad, axis=0)])
    ws_t = torch.as_tensor(ws[collective_rows(K + pad, mesh)], device=dev)
    heaps: List[List[tuple]] = [[] for _ in range(K)]
    counter = 0
    for path_id, tensors in _prefetch_shards(shard_paths):
        for key, data in tensors.items():
            paths = key.split(";;")
            B, W, H, C = data.shape
            feats = torch.as_tensor(data.reshape(B, W * H, C), device=dev).float()
            mask = None
            if fold is not None:
                mask = torch.as_tensor(fold_mask(path_id, B, W * H, fold), device=dev)
            best_t, arg_t = search_block(feats, ws_t, mask)
            best = all_gather_rows(best_t, mesh)[:K].cpu().numpy()
            arg = all_gather_rows(arg_t, mesh)[:K].cpu().numpy()
            # only candidates that can enter a heap are visited in Python
            thresholds = np.asarray([h[0][0] if len(h) >= top_k else -np.inf for h in heaps], np.float32)
            gate = best > thresholds[:, None]
            if only_pos:
                gate &= best > 0
            for k, b in np.argwhere(gate):
                v = float(best[k, b])
                item = (v, counter, make_bbox(int(arg[k, b]), (W, H)), paths[b])
                counter += 1
                if ret_ws:
                    item = item + (np.asarray(data[b].reshape(W * H, C)[int(arg[k, b])], np.float32),)
                if len(heaps[k]) < top_k:
                    heapq.heappush(heaps[k], item)
                elif v > heaps[k][0][0]:
                    heapq.heapreplace(heaps[k], item)
    out = []
    for k in range(K):
        items = sorted(heaps[k], key=lambda x: -x[0])
        out.append([(it[0],) + tuple(it[2:]) for it in items])
    return out


def random_sample(shard_paths: Sequence[str], fold=None, num_samples: int = 10000, seed: int = 0):
    """Random negative feature vectors from the shard store."""
    rng = random.Random(seed)
    paths = list(shard_paths)
    rng.shuffle(paths)
    out = []
    per_block = max(1, num_samples // max(len(paths), 1))
    for sp in paths:
        tensors = load_shard(sp)
        keys = list(tensors.keys())
        rng.shuffle(keys)
        per_key = max(1, per_block // max(len(keys), 1))
        for key in keys:
            data = tensors[key]
            B, W, H, C = data.shape
            flat = data.reshape(B * W * H, C)
            n = B * W * H
            if fold is not None:
                indices = np.random.RandomState(0).permutation(n)[: (fold[0] * n) // fold[1]]
            else:
                indices = np.arange(n)
            for i in rng.sample(list(indices), min(per_key, len(indices))):
                out.append(flat[i].astype(np.float32))
                if len(out) >= num_samples:
                    return out
    return out


class Doersch:
    def __init__(self, main_dir: str, which: str, dataset_path: str, seed: int = 42,
                 how_many: int = 25000, threshold: int = 50, mesh: Optional[Mesh] = None, device="cuda"):
        self.main_dir = main_dir
        self.mesh = mesh  # the dense searches' detector axis over dp; rank 0 writes
        self.which = which
        self.seed = seed
        self.how_many = how_many
        self.threshold = threshold
        self.device = resolve_device(device)
        load = {"geo": self._load_geo, "ftt": self._load_ftt, "cars": self._load_cars}[which]
        load(dataset_path)
        self.store = FeatureStore(join(main_dir, which, "hog_cache"), join(main_dir, which, "safetensors"),
                                  device=self.device, mesh=mesh)
        self.paths = {c: list(self.get_seeds(c)) for c in self.categories()}

    # --- dataset loaders (the typicality protocols) ---

    def _load_geo(self, dataset_path: str):
        self.country_path = defaultdict(list)
        for parent in sorted(os.listdir(dataset_path)):
            d = join(dataset_path, parent)
            if not os.path.isdir(d):
                continue
            for seed in sorted(os.listdir(d)):
                country = seed.split("__")[0]
                if country.startswith("gt--"):
                    self.country_path[country.replace("gt--", "")].append((join(d, seed), True))
        self._cats = sorted(self.country_path.keys())

    def _load_ftt(self, dataset_path: str):
        self.times = defaultdict(list)
        for t in sorted(os.listdir(dataset_path)):
            if os.path.isdir(join(dataset_path, t)):
                for p in sorted(os.listdir(join(dataset_path, t))):
                    self.times[t].append(join(dataset_path, t, p))
        self._cats = sorted(self.times.keys())

    def _load_cars(self, dataset_path: str):
        self.times = defaultdict(list)
        with open(dataset_path + ".json") as f:
            meta = json.load(f)
        for image in sorted(os.listdir(dataset_path)):
            self.times[get_decade(meta[image]["year"])].append(join(dataset_path, image))
        self._cats = sorted(self.times.keys())

    def categories(self) -> List[str]:
        return self._cats

    def get_seeds(self, c: str) -> List[str]:
        if self.which == "geo":
            return [p for p, is_gt in self.country_path[c] if is_gt]
        return list(self.times[c])

    # --- positive and negative splits (cached) ---

    def _cached_shuffle(self, fname: str, build) -> List[str]:
        fp = join(self.main_dir, self.which, fname)
        if is_writer(self.mesh) and not os.path.isfile(fp):
            atomic_save_pickle(fp, build())
        host_barrier("doersch_split")  # the other ranks read rank 0's file
        with open(fp, "rb") as f:
            return pickle.load(f)

    def positive_paths(self, c: str, i=None, l=None) -> List[str]:
        def build():
            idx = list(range(len(self.paths[c])))
            random.Random(self.seed).shuffle(idx)
            return [self.paths[c][i] for i in idx]

        paths = self._cached_shuffle(join(c, f"pos_all_{self.seed}_hog.pkl"), build)
        if l is None:
            return paths
        return paths[len(paths) * i // l: len(paths) * (i + 1) // l]

    def negative_paths(self, c: str, i=None, l=None) -> List[str]:
        def build():
            paths = []
            for j, cp in enumerate(self.paths.keys()):
                if cp == c:
                    continue
                idx = list(range(len(self.paths[cp])))
                random.Random(self.seed * 2 + j).shuffle(idx)
                paths += [self.paths[cp][i] for i in idx]
            random.Random(self.seed * 2 + len(self.paths) + 1).shuffle(paths)
            return paths

        paths = self._cached_shuffle(join(c, f"neg_all_{self.seed}_hog.pkl"), build)
        if l is None:
            return paths
        return paths[len(paths) * i // l: len(paths) * (i + 1) // l]

    # --- init patches and detectors ---

    def init_patches(self, c: str, how_many: int, num_trials: int = 100) -> List[Tuple[tuple, str]]:
        """Random non-overlapping high-contrast 64×64 patches."""
        rng = random.Random(self.seed)
        nprng = np.random.RandomState(self.seed)
        seeds = list(self.get_seeds(c))
        rng.shuffle(seeds)
        patches, per_img = [], defaultdict(set)
        key_id, budget = 0, how_many * 20
        while len(patches) < how_many and budget > 0:
            budget -= 1
            path = seeds[key_id]
            key_id = (key_id + 1) % len(seeds)
            with Image.open(path) as img:
                W, H = img.size
                gw, gh = W // 8 - 8, H // 8 - 8
                if gw <= 0 or gh <= 0:
                    continue
                for _ in range(num_trials):
                    x, y = int(nprng.randint(gw)), int(nprng.randint(gh))
                    if (x, y) in per_img[path]:
                        continue
                    per_img[path].add((x, y))
                    bbox = (x * 8, y * 8, x * 8 + 64, y * 8 + 64)
                    if patch_has_contrast(img.crop(bbox), self.threshold):
                        patches.append((bbox, path))
                        break
        return patches

    def detector_vectors(self, patches) -> np.ndarray:
        """[len(patches), C]: the feature at each (bbox, path)'s grid position
        (the JAX package's ``detector_vector`` of each), reading each image's
        feature map once (the JAX package reads it once a patch)."""
        by_path = defaultdict(list)
        for j, (bbox, path) in enumerate(patches):
            by_path[path].append((j, bbox))
        ws = None
        for path, items in by_path.items():
            feats = self.store.image_features(path)
            if ws is None:
                ws = np.empty((len(patches), feats.shape[-1]), feats.dtype)
            for j, bbox in items:
                ws[j] = feats[bbox[0] // 8, bbox[1] // 8]
        return ws

    def init_detectors(self, c: str, patches, batch_size: int = 256):
        """Dense-search every init patch; record its top-20 purity and its
        neighbours."""
        pos = self.positive_paths(c)
        neg = self.negative_paths(c)
        pos_set = set(pos)
        shards = self.store.build_shards(pos + neg, f"{c}-all")
        meta = {"discriminative-20": {}, "neighbors": {}, "w": {}}
        for start in range(0, len(patches), batch_size):
            chunk = patches[start:start + batch_size]
            ws = self.detector_vectors(chunk)
            results = dense_search(ws, shards, top_k=50, mesh=self.mesh, device=self.device)
            for j, bf in enumerate(results):
                idx = start + j
                meta["discriminative-20"][idx] = sum(1 for y in bf[:20] if y[-1] in pos_set)
                meta["neighbors"][idx] = [(y[1], y[2]) for y in bf]
                meta["w"][idx] = ws[j]
        return meta

    def rank_init_detectors(self, num_detectors: int, stats, patches):
        """Greedy purity ranking with IoU > 0.3 neighbour dedup."""
        out, buffers = [], {}
        for k, _v in sorted(stats["discriminative-20"].items(), key=lambda x: x[1], reverse=True):
            if len(out) == num_detectors:
                break
            buffer = defaultdict(list)
            for bbox, path in stats["neighbors"][k]:
                buffer[path].append(bbox)
            ok = True
            for d, _patch, _w in out:
                count = 0
                for path, bboxes in buffers[d].items():
                    for bbox in buffer.get(path, []):
                        for bboxp in bboxes:
                            if iou(bbox + (bbox[0] + 64, bbox[1] + 64), bboxp + (bboxp[0] + 64, bboxp[1] + 64)) > 0.3:
                                count += 1
                                if count > 5:
                                    ok = False
                                    break
                        if not ok:
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if ok:
                out.append((k, patches[k], stats["w"][k]))
                buffers[k] = buffer
        return out

    def initialize_classifier(self, c: str, num_detectors: int = 1000):
        fp = join(self.main_dir, self.which, c,
                  f"init_ws_{self.seed}_{self.threshold}_{self.how_many}_{num_detectors}_hog.pkl")
        cached = os.path.isfile(fp)
        # every rank has decided before rank 0 writes: all run the dense
        # searches of the init together, or none does
        host_barrier("doersch_init")
        if cached:
            with open(fp, "rb") as f:
                return pickle.load(f)
        patches = self.init_patches(c, self.how_many)
        stats = self.init_detectors(c, patches)
        ranked = self.rank_init_detectors(num_detectors, stats, patches)
        if is_writer(self.mesh):
            atomic_save_pickle(fp, ranked)
        return ranked

    # --- iterative SVM clustering ---

    def _train_chunk_batched(self, positives, hard_negatives, neg_shards, fold, seed):
        """One solve for the whole detector chunk (ops/svm
        fit_linear_svm_batch). As in the JAX package, one shared negative
        pool is drawn per fold and detector j uses its first max(25000 −
        len(hn_j), 10000) rows, where the per-detector path draws a sample
        per detector."""
        J = len(positives)
        pool = np.stack(random_sample(neg_shards, fold=fold, num_samples=25000, seed=seed)).astype(np.float32)
        M, D = pool.shape
        m_counts = [min(M, max(25000 - len(hn), 10000)) for hn in hard_negatives]
        p_max = max(1, max(len(p) for p in positives))
        h_max = max(1, max(len(hn) for hn in hard_negatives))
        P = np.zeros((J, p_max, D), np.float32)
        Pm = np.zeros((J, p_max), np.float32)
        HN = np.zeros((J, h_max, D), np.float32)
        HNm = np.zeros((J, h_max), np.float32)
        NEGm = np.zeros((J, M), np.float32)
        for j in range(J):
            for k, (_s, _bbox, _path, w) in enumerate(positives[j]):
                P[j, k] = w
                Pm[j, k] = 1.0
            for k, hv in enumerate(hard_negatives[j]):
                HN[j, k] = hv
                HNm[j, k] = 1.0
            NEGm[j, : m_counts[j]] = 1.0
        W, b, scores = fit_linear_svm_batch(P, Pm, HN, HNm, pool, NEGm, device=self.device)
        # hard-negative mining, train_svm's rule: misclassified negatives of
        # the detector's own active rows, sorted by score desc, capped
        for j in range(J):
            s = scores[: m_counts[j], j]
            idx = np.where(s > 0)[0]
            idx = idx[np.argsort(-s[idx])][: max(25000 - len(hard_negatives[j]), 10000)]
            hard_negatives[j] += [pool[i] for i in idx]
        return W, hard_negatives

    def iterative_clustering(self, c: str, l: int = 3, top_k: int = 32, top_elem: int = 7,
                             num_detectors: int = 1000, batch_size: int = 64):
        pos_set = set(self.positive_paths(c))
        init = self.initialize_classifier(c, num_detectors=num_detectors)
        all_shards = self.store.build_shards(self.positive_paths(c) + self.negative_paths(c), f"{c}-all")
        pos_shards = self.store.build_shards(self.positive_paths(c), f"{c}-pos", num_splits=1)
        neg_shards = self.store.build_shards(self.negative_paths(c), f"{c}-neg", num_splits=4)

        det_dir = join(self.main_dir, self.which, c, "detectors", str(self.threshold))
        writer = is_writer(self.mesh)
        if writer:
            os.makedirs(det_dir, exist_ok=True)
        data = []
        for start in range(0, len(init), batch_size):
            chunk = init[start:start + batch_size]
            fps = [join(det_dir, f"5_{start + j}.pkl") for j in range(len(chunk))]
            cached = all(os.path.isfile(fp) for fp in fps)
            # as initialize_classifier: the chunk's searches run on every rank or on none
            host_barrier("doersch_detectors")
            if cached:
                for fp in fps:
                    with open(fp, "rb") as f:
                        accuracy, _e, top_detections, _w = pickle.load(f)
                    data.append((accuracy, top_detections[:top_elem]))
            else:
                ws = np.stack([w for _k, _p, w in chunk])
                hard_negatives: List[List] = [[] for _ in range(len(chunk))]
                use_batch = os.environ.get("DIFFMINING_DOERSCH_BATCH_SVM", "1") != "0"
                for i in range(l):
                    positives = dense_search(ws, pos_shards, fold=(i + 1, l), top_k=5, ret_ws=True,
                                             mesh=self.mesh, device=self.device)
                    if use_batch:
                        ws, hard_negatives = self._train_chunk_batched(
                            positives, hard_negatives, neg_shards, fold=(i + 1, l), seed=i)
                        continue
                    negatives = [random_sample(neg_shards, fold=(i + 1, l), num_samples=max(25000 - len(hn), 10000),
                                               seed=i) for hn in hard_negatives]
                    new_ws = []
                    for j, (p, n, hn) in enumerate(zip(positives, negatives, hard_negatives)):
                        X = [w for _score, _bbox, _path, w in p] + hn + n
                        split = (len(p), len(hn), len(n))
                        w, negs = train_svm(X, split, max(25000 - split[1], 10000), device=self.device)
                        new_ws.append(w)
                        hard_negatives[j] += negs
                    ws = np.stack(new_ws)
                final = dense_search(ws, all_shards, top_k=100, mesh=self.mesh, device=self.device)
                for j, (e, fp) in enumerate(zip(final, fps)):
                    accuracy = sum(1 for y in e if y[-1] in pos_set)
                    top_detections = [(bbox, path) for _s, bbox, path in e if path in pos_set]
                    if writer:
                        atomic_save_pickle(fp, (accuracy, e, top_detections, ws[j]))
                    data.append((accuracy, top_detections[:top_elem]))
        return sorted(data, key=lambda x: x[0], reverse=True)[:top_k]

    def plot_detectors(self, c: str, max_rows: int = 32, max_elems: int = 30) -> Optional[Image.Image]:
        """Debug strips: one row per trained detector, its top detections side
        by side, a blue border when the detection comes from a positive image
        and red otherwise. Reads the detector pkls written by
        iterative_clustering; None until those exist."""
        det_dir = join(self.main_dir, self.which, c, "detectors", str(self.threshold))
        if not os.path.isdir(det_dir):
            return None
        pos_set = set(self.positive_paths(c))
        rows = []

        def det_key(fname: str):
            # "{round}_{rank}.pkl", sorted numerically so 5_2 precedes 5_10
            parts = os.path.splitext(fname)[0].split("_")
            return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in parts]

        for fname in sorted(os.listdir(det_dir), key=det_key)[:max_rows]:
            with open(join(det_dir, fname), "rb") as f:
                _acc, detections, _top, _w = pickle.load(f)
            crops = []
            for _score, bbox, path in detections[:max_elems]:
                crop = Image.open(path).crop((bbox[0], bbox[1], bbox[0] + 64, bbox[1] + 64))
                crops.append(add_border(crop, "blue" if path in pos_set else "red", border=2))
            if crops:
                rows.append(hcat(crops))
        if not rows:
            return None
        img = vcat(rows, vertical_spacing=2)
        if not is_writer(self.mesh):
            return img
        out_dir = join(self.main_dir, self.which, c, "plots", str(self.threshold), "detectors")
        os.makedirs(out_dir, exist_ok=True)
        img.save(join(out_dir, "init.png"))
        return img

    def get_top(self, c: str, top_k: int = 32, top_elem: int = 7, **kw) -> Image.Image:
        data = self.iterative_clustering(c=c, top_k=top_k, top_elem=top_elem, **kw)
        lines = []
        for _acc, detections in data:
            if detections:
                lines.append(hcat([Image.open(path).crop((b[0], b[1], b[0] + 64, b[1] + 64))
                                   for b, path in detections]))
        img = vcat(lines, vertical_spacing=4)
        if not is_writer(self.mesh):
            return img
        fname = join(self.main_dir, self.which, c, f"top_{self.seed}_{self.threshold}_{self.how_many}_hog_final.png")
        os.makedirs(os.path.dirname(fname), exist_ok=True)
        img.save(fname)
        return img


def main(argv=None):
    p = argparse.ArgumentParser(description="Doersch baseline (reference doersch.py CLI)")
    p.add_argument("--threshold", type=int, default=50)
    p.add_argument("--how_many", type=int, default=25000)
    p.add_argument("--main_dir", type=str, default="doersch-hog")
    p.add_argument("--which", type=str, default="geo", choices=["ftt", "cars", "geo"])
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--category", type=str, default="United States")
    p.add_argument("--mesh_dp", type=int, default=None,
                   help="shard each dense search's detectors over this many processes, one GPU each (default "
                   "under torchrun: every rank); above 1, launch under torchrun --nproc_per_node MESH_DP")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    try:
        d = Doersch(args.main_dir, args.which, args.dataset_path, how_many=args.how_many, threshold=args.threshold,
                    mesh=cli_mesh("doersch", args.mesh_dp, args.device), device=args.device)
        d.get_top(c=args.category)
    finally:
        destroy()


if __name__ == "__main__":
    main()
