"""Finetuning datasets: the per-domain loaders with the reference's prompt
templates, null-dropout probabilities and crop/resize rules, and the
threaded batch iterator (counterpart of diffmining_tpu/finetuning/datasets.py;
reference finetuning/cars.py:40-99 CarDB, ftt.py:37-66 FTT, geo.py:36-81 G3,
places.py:34-70 G3r, applications/xray/finetune.py:36-69 XRay).

PIL is imported only inside the decode functions, so a caller that hands in
decoded arrays (``load=``, ``path -> [H, W, 3] float32 in [-1, 1]``) runs
where Pillow is not installed. The per-item draws (crop, prompt dropout)
come from ``random.Random(seed, epoch, index)``, as in the JAX package, so
both give the same crops and prompts.
"""
from __future__ import annotations

import csv
import json
import os
import queue
import random
import threading
from os.path import join
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from diffmining_tpu_torch.models.tokenizer import CLIPTokenizer
from diffmining_tpu_torch.typicality.templates import get_decade
from diffmining_tpu_torch.utils.images import array_from_uint8, rescale_short_side

Loader = Callable[[str], np.ndarray]


def _decode(path: str, short: Optional[int] = None, ceil_mode: bool = False) -> np.ndarray:
    """Decode an RGB image (optionally short-side rescaled) to [H, W, 3]
    float32 in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if short is not None:
        img = rescale_short_side(img, short, ceil_mode=ceil_mode)
    return array_from_uint8(np.asarray(img))


def random_crop(arr: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    h, w = arr.shape[:2]
    if h < size or w < size:  # pad-reflect small images up to crop size
        ph, pw = max(0, size - h), max(0, size - w)
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = arr.shape[:2]
    i = rng.randint(0, h - size) if h > size else 0
    j = rng.randint(0, w - size) if w > size else 0
    return arr[i : i + size, j : j + size]


class PromptDataset:
    """Base: subclasses fill self.items = [(path, label_info)] and implement
    load_image(path) and prompt(label, rng)."""

    resolution: int = 256

    def __init__(self, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        self.tokenizer = tokenizer
        self.items: List[Tuple[str, Any]] = []
        self.seed = seed
        self.load = load

    def __len__(self):
        return len(self.items)

    def load_image(self, path: str) -> np.ndarray:
        raise NotImplementedError

    def prompt(self, label, rng: random.Random) -> str:
        raise NotImplementedError

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, Any]:
        rng = random.Random(self.seed * 1_000_003 + epoch * 9_176 + i)
        path, label = self.items[i]
        arr = (self.load or self.load_image)(path)
        arr = random_crop(arr, self.resolution, rng)
        prompt = self.prompt(label, rng)
        tokens = self.tokenizer([prompt])[0]
        return dict(image=arr, prompt=prompt, tokenized=tokens)


class CarDB(PromptDataset):
    """'A car from the {decade}s.' with 5% base-prompt dropout; short side 256
    + RandomCrop 256 (reference cars.py:40-77)."""

    NEGATIVE_PROMPT = "A car"
    resolution = 256

    def __init__(self, data_path: str, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        super().__init__(tokenizer, seed, load)
        with open(join(data_path, "train.json")) as f:
            self.metadata = json.load(f)
        for image in sorted(os.listdir(join(data_path, "train"))):
            self.items.append((join(data_path, "train", image), get_decade(self.metadata[image]["year"])))

    def load_image(self, path: str) -> np.ndarray:
        return _decode(path, 256)

    def prompt(self, decade: str, rng: random.Random) -> str:
        if rng.random() < 0.05:
            return self.NEGATIVE_PROMPT + "."
        return self.NEGATIVE_PROMPT + " from the " + decade + "s."


class FTT(PromptDataset):
    """Decade-folder face portraits, native resolution, 10% null dropout
    (reference ftt.py:37-66)."""

    BASE_PROMPT = "A face portrait"
    resolution = 256

    def __init__(self, data_path: str, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        super().__init__(tokenizer, seed, load)
        # the reference reads {data_path}/train/{decade}/ (ftt.py:40-42);
        # accept a path that already points at the split too
        root = join(data_path, "train") if os.path.isdir(join(data_path, "train")) else data_path
        for t in sorted(os.listdir(root)):
            if not os.path.isdir(join(root, t)):
                continue
            for name in sorted(os.listdir(join(root, t))):
                self.items.append((join(root, t, name), t))

    def load_image(self, path: str) -> np.ndarray:
        return _decode(path)

    def prompt(self, decade: str, rng: random.Random) -> str:
        # null keeps the bare base prompt, no period (ftt.py:61-65)
        if rng.random() < 0.1:
            return self.BASE_PROMPT
        return self.BASE_PROMPT + " of the " + decade + "s."


class G3(PromptDataset):
    """Street-view panoramas: metadata.csv (id,country,region,...) with images
    at `images/{id}/{angle}.jpg`, angles 45/135/225/315, exclude.json of
    `{id}/{angle}.jpg` names; RandomCrop 512; prompt p=[.05 null, .85 country,
    .10 country+region] (reference geo.py:36-81)."""

    BASE_PROMPT = "A google street view image"
    resolution = 512
    ANGLES = ("45", "135", "225", "315")

    def __init__(self, data_path: str, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        super().__init__(tokenizer, seed, load)
        exclude = set()
        if os.path.isfile(join(data_path, "exclude.json")):
            with open(join(data_path, "exclude.json")) as f:
                exclude = set(json.load(f))
        image_folder = join(data_path, "images")
        with open(join(data_path, "metadata.csv")) as f:
            for row in csv.DictReader(f):
                key = row.get("id") or row.get("key")
                if not key or not os.path.isdir(join(image_folder, key)):
                    continue
                country = row.get("country", "") or ""
                region = row.get("region", "") or ""
                for a in self.ANGLES:
                    if join(key, f"{a}.jpg") in exclude:
                        continue
                    p = join(image_folder, key, f"{a}.jpg")
                    if os.path.isfile(p):
                        self.items.append((p, (country, region)))

    def load_image(self, path: str) -> np.ndarray:
        return _decode(path)

    def prompt(self, label: Tuple[str, str], rng: random.Random) -> str:
        country, region = label
        i = rng.choices([0, 1, 2], weights=[0.05, 0.85, 0.10])[0]
        prompt = self.BASE_PROMPT
        if i >= 1:
            prompt = prompt + " in " + str(country)
        if i == 2 and region:
            prompt = prompt + ", at the region of " + str(region)
        return prompt


class G3r(PromptDataset):
    """Recursive folder dataset ('places'): category = folder name; 512px
    resize + RandomCrop 512; 'Image of {category}.' with 5% null
    (reference places.py:34-70)."""

    resolution = 512

    def __init__(self, data_path: str, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        super().__init__(tokenizer, seed, load)
        # places365 layout {data_path}/{letter}/{category}[/{sub}]/img: the
        # category label is "{sub}_{category}" for 3-level entries
        for letter in sorted(os.listdir(data_path)):
            lp = join(data_path, letter)
            if not os.path.isdir(lp):
                continue
            for category in sorted(os.listdir(lp)):
                cp = join(lp, category)
                if not os.path.isdir(cp):
                    continue
                for fp in sorted(os.listdir(cp)):
                    if os.path.isdir(join(cp, fp)):
                        for fpp in sorted(os.listdir(join(cp, fp))):
                            self.items.append((join(cp, fp, fpp), fp + "_" + category))
                    else:
                        self.items.append((join(cp, fp), category))

    def load_image(self, path: str) -> np.ndarray:
        return _decode(path, 512, ceil_mode=True)

    def prompt(self, category: str, rng: random.Random) -> str:
        if rng.random() < 0.05:
            return ""
        return "Image of " + category.replace("_", " ") + "."


class XRay(PromptDataset):
    """NIH ChestX-ray14: metadata csv + train_val_list.txt; 'Chest X-Ray with
    {labels}.' with 5% base-only; 'No Finding' -> 'no finding' (reference
    applications/xray/finetune.py:36-69)."""

    BASE_PROMPT = "Chest X-Ray"
    resolution = 512

    def __init__(self, data_path: str, tokenizer: CLIPTokenizer, seed: int = 0, load: Optional[Loader] = None):
        super().__init__(tokenizer, seed, load)
        labels: Dict[str, str] = {}
        with open(join(data_path, "metadata.csv")) as f:
            for row in csv.DictReader(f):
                name = row.get("Image Index") or row.get("image")
                labels[name] = row.get("Finding Labels") or row.get("labels", "")
        with open(join(data_path, "train_val_list.txt")) as f:
            for line in f:
                name = line.strip()
                if name and name in labels:
                    self.items.append((join(data_path, "images", name), labels[name]))

    def load_image(self, path: str) -> np.ndarray:
        # native resolution: the reference applies no resize (finetune.py:52-55)
        return _decode(path)

    def prompt(self, finding: str, rng: random.Random) -> str:
        prompt = self.BASE_PROMPT
        if rng.random() >= 0.05:
            prompt = prompt + " with " + ", ".join(finding.replace("_", " ").split("|"))
        return prompt.replace("No Finding", "no finding") + "."


class BatchIterator:
    """Shuffled, epoch-aware, thread-prefetched batches of stacked arrays:
    image [B, H, W, 3] float32, tokenized [B, 77], prompt (list). The last
    partial batch of an epoch is dropped."""

    def __init__(self, dataset: PromptDataset, batch_size: int, seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, Any]]:
        idx = list(range(len(self.dataset)))
        random.Random(self.seed * 1_000_003 + epoch).shuffle(idx)
        batches = [idx[i : i + self.batch_size] for i in range(0, len(self) * self.batch_size, self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_ids in batches:
                    items = [self.dataset.__getitem__(i, epoch) for i in batch_ids]
                    if not put(dict(
                        image=np.stack([it["image"] for it in items]).astype(np.float32),
                        tokenized=np.stack([it["tokenized"] for it in items]),
                        prompt=[it["prompt"] for it in items],
                    )):
                        return  # the consumer stopped early
            except Exception as ex:  # handed to the consumer, which re-raises it
                put(ex)
                return
            put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


DATASETS = {"cars": CarDB, "ftt": FTT, "geo": G3, "places": G3r, "xray": XRay}
