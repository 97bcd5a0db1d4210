"""The port's finetuning datasets held to the JAX package's: the same items
from each domain's directory protocol, and for every item and epoch the same
crop, prompt and token ids; the batch iterator yields the same batches.
The per-item draws come from ``random.Random`` seeded alike in both, and
the decode is the same PIL code, so everything must be equal exactly.
"""
import csv
import json
import os
from os.path import join

import numpy as np
import pytest
from PIL import Image

from diffmining_tpu.finetuning import datasets as jds
from diffmining_tpu.models.tokenizer import tiny_tokenizer as j_tiny_tokenizer

from diffmining_tpu_torch.finetuning import datasets as pds
from diffmining_tpu_torch.models.tokenizer import tiny_tokenizer


def _img(path, size, seed):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, size + (3,), dtype=np.uint8)).save(path)


def _layout(root: str, which: str) -> None:
    """A small tree in the domain's layout, images of uneven sizes (some
    below the crop, so the reflect-pad runs too)."""
    if which == "cars":
        meta = {}
        for i, year in enumerate((1931, 1987, 2003)):
            _img(join(root, "train", f"car{i}.jpg"), (40 + 30 * i, 50), i)
            meta[f"car{i}.jpg"] = {"year": year}
        with open(join(root, "train.json"), "w") as f:
            json.dump(meta, f)
    elif which == "ftt":
        for i, dec in enumerate(("1930", "1950", "1950")):
            _img(join(root, "train", dec, f"f{i}.png"), (60, 48 + 20 * i), i)
    elif which == "geo":
        for a in ("45", "135", "225", "315"):
            _img(join(root, "images", "id1", f"{a}.jpg"), (70, 60), int(a))
        with open(join(root, "metadata.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "country", "region"])
            w.writerow(["id1", "France", "Provence"])
        with open(join(root, "exclude.json"), "w") as f:
            json.dump(["id1/315.jpg"], f)
    elif which == "places":
        _img(join(root, "a", "arch", "x.jpg"), (90, 64), 1)
        _img(join(root, "n", "nature", "wild", "y.jpg"), (64, 100), 2)
        _img(join(root, "n", "nature", "z.jpg"), (30, 30), 3)
    else:  # xray
        with open(join(root, "metadata.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Image Index", "Finding Labels"])
            for i, lab in enumerate(("No Finding|Pleural_Thickening", "Effusion", "Cardiomegaly|Effusion")):
                _img(join(root, "images", f"x{i}.png"), (56 + 8 * i, 56), i)
                w.writerow([f"x{i}.png", lab])
        with open(join(root, "train_val_list.txt"), "w") as f:
            f.write("x0.png\nx2.png\nmissing.png\n")


@pytest.mark.parametrize("which", ["cars", "ftt", "geo", "places", "xray"])
def test_dataset_items_crops_prompts_tokens_equal_jax(which, tmp_path):
    root = str(tmp_path)
    _layout(root, which)
    want = jds.DATASETS[which](root, j_tiny_tokenizer(), seed=3)
    got = pds.DATASETS[which](root, tiny_tokenizer(), seed=3)
    assert got.items == want.items and len(got) > 0
    for res in (32, want.resolution):
        want.resolution = got.resolution = res
        for epoch in (0, 1):
            for i in range(len(got)):
                w, g = want.__getitem__(i, epoch), got.__getitem__(i, epoch)
                assert g["prompt"] == w["prompt"]
                np.testing.assert_array_equal(np.asarray(g["tokenized"]), np.asarray(w["tokenized"]))
                np.testing.assert_array_equal(g["image"], w["image"])
    # the prompt distribution (dropout included) over many draws
    import random

    for i in range(len(got)):
        label = got.items[i][1]
        assert {got.prompt(label, random.Random(s)) for s in range(300)} == {
            want.prompt(label, random.Random(s)) for s in range(300)}


def test_batch_iterator_equals_jax(tmp_path):
    root = str(tmp_path)
    _layout(root, "ftt")
    for i in range(3, 7):
        _img(join(root, "train", "1970", f"g{i}.png"), (40, 40), i)
    want = jds.DATASETS["ftt"](root, j_tiny_tokenizer(), seed=1)
    got = pds.DATASETS["ftt"](root, tiny_tokenizer(), seed=1)
    want.resolution = got.resolution = 24
    jit = jds.BatchIterator(want, batch_size=3, seed=5, num_threads=1)
    pit = pds.BatchIterator(got, batch_size=3, seed=5)
    assert len(pit) == len(jit) == 2
    for epoch in (0, 1):
        wb, gb = list(jit.epoch(epoch)), list(pit.epoch(epoch))
        assert len(gb) == len(wb)
        for w, g in zip(wb, gb):
            assert g["prompt"] == w["prompt"]
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(np.asarray(g["tokenized"]), np.asarray(w["tokenized"]))


def test_batch_iterator_stops_early_and_hands_over_errors(tmp_path):
    """A consumer that stops after one batch stops the loader thread; an
    image that fails to decode raises in the consumer."""
    root = str(tmp_path)
    _layout(root, "ftt")
    ds = pds.DATASETS["ftt"](root, tiny_tokenizer(), seed=1)
    ds.resolution = 16
    it = pds.BatchIterator(ds, batch_size=1, seed=0)
    gen = it.epoch(0)
    next(gen)
    gen.close()

    def broken(path):
        raise OSError(f"cannot decode {path}")

    ds.load = broken
    with pytest.raises(OSError, match="cannot decode"):
        list(it.epoch(0))
