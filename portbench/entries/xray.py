"""The X-ray application: ``applications/xray.py`` ``XRayTypicality`` at
1024 x 1024, its ``pixel_maps`` over same-shape groups (N (eps, t) draws
over the whole t range, conditions [disease, ""], through the sweep engine;
the map is mean_n of L_null - L_cond, upsampled to the image), each map
saved as ``main`` saves it. The images are PNG files the run writes once
(a pool, each name a link to a pool file, so that every name has its own
draws); the draws come through the ``draws`` hook, from the seed.

The window runs whole groups until ``--seconds`` have passed; the rate is
images over the host time.

The check draws images of the first group from the seed, from both halves
of the group; for them the benchmark keeps the loss grids the engine
returned. The float32 reference
recomputes a sample of its draws (``losses_rel_l2``) and, from the
program's own grid, the map stage alone (``map_rel_l2``): that stage is
the only one the program's grid feeds, and the grid itself is checked by
the first number.
"""
from __future__ import annotations

import contextlib
import os
import random
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench import traffic
from portbench.entries.common import free, halves, rel_l2
from portbench import counts
from portbench.entries.sweep import (_key, apply_fault, build_sd, draws_hook, instrument, reference_losses,
                                     reference_models)
from portbench.harness import Window
from portbench.reference.common import Precision
from portbench.seeds import derive
from portbench.tracing import launches, patched


def write_pool(run, root: str):
    from PIL import Image

    tr = run.traffic
    pool = traffic.images(run.seed, "pool", tr["distinct_images"], tr["height"], tr["width"], run.device)
    os.makedirs(root, exist_ok=True)
    files = []
    for i, x in enumerate(pool):
        path = os.path.join(root, f"pool{i}.png")
        Image.fromarray(traffic.to_uint8(x)).save(path)
        files.append(path)
    return files


def setup(run):
    import diffmining_tpu_torch.applications.xray as port_xray

    tr = run.traffic
    sd = build_sd(run, [])
    apply_fault(run, sd.unet)
    gt = os.path.join(run.scratch, "gt")
    os.makedirs(os.path.join(gt, "images"), exist_ok=True)
    with open(os.path.join(gt, "metadata.csv"), "w") as f:
        f.write("Image Index,Finding Labels\n")
    with open(os.path.join(gt, "BBox_List_2017.csv"), "w") as f:
        f.write("Image Index,Finding Label,Bbox [x,y,w,h],,,\n")
    xr = port_xray.XRayTypicality(sd, gt, os.path.join(run.scratch, "out"), diseases=[tr["disease"]],
                                  seed=run.seed, N=tr["N"], chunk=tr["chunk"], draws=draws_hook(run, tr["N"]))
    pool = write_pool(run, os.path.join(gt, "pool"))
    B = tr["batch_images"]
    rng = random.Random(derive(run.seed, "check"))
    keep = halves(rng, list(range(B)), B, int(run.workload["check"]["images"]))
    kept = {}

    def sweep_factory(orig):
        def sweep_images(sd_, engine, draws, images, uids, ctx):
            losses = orig(sd_, engine, draws, images, uids, ctx)
            for b, uid in enumerate(uids):
                if uid in cell["keep_uid"]:
                    kept[uid] = losses[b].cpu()
            return losses

        return sweep_images

    cell = {"sd": sd, "xr": xr, "pool": pool, "next": 10 ** 6, "done": [], "kept": kept, "keep": keep,
            "keep_uid": {}, "port": port_xray, "maps": os.path.join(run.scratch, "maps")}
    cell["patch"] = patched(port_xray, "sweep_images", sweep_factory)
    cell["patch"].__enter__()
    # the warm-up: one group of ``chunk`` draws, which runs the UNet at the
    # window's batch (the engine snaps its chunk to a divisor of N alike)
    cell["xr"] = port_xray.XRayTypicality(sd, gt, os.path.join(run.scratch, "out"), diseases=[tr["disease"]],
                                          seed=run.seed, N=warm_draws(tr), chunk=tr["chunk"],
                                          draws=draws_hook(run, warm_draws(tr)))
    group(run, cell)
    cell["xr"], cell["next"], cell["done"] = xr, 0, []
    kept.clear()
    cell["keep_uid"] = {traffic.uid(name(cell, k)): k for k in keep}
    return cell


def warm_draws(tr) -> int:
    """The fewest draws at which the engine runs the window's chunk."""
    c = min(tr["chunk"], tr["N"])
    while tr["N"] % c:
        c -= 1
    return c


def name(cell, k: int) -> str:
    return os.path.join(os.path.dirname(cell["pool"][0]), "..", "images", f"{k:07d}.png")


def group(run, cell) -> int:
    from diffmining_tpu_torch.utils.artifacts import atomic_save_npy

    B = run.traffic["batch_images"]
    ks = list(range(cell["next"], cell["next"] + B))
    paths = []
    for k in ks:
        p = os.path.normpath(name(cell, k))
        if not os.path.exists(p):
            os.symlink(cell["pool"][k % len(cell["pool"])], p)
        paths.append(p)
    maps = cell["xr"].pixel_maps(run.traffic["disease"], paths)
    os.makedirs(cell["maps"], exist_ok=True)
    for k, dm in zip(ks, maps):
        atomic_save_npy(os.path.join(cell["maps"], f"{k:07d}_loss_pixel.npy"), dm)
    cell["done"].extend(ks)
    cell["next"] += B
    return B


def window(run, cell) -> Window:
    t0 = time.perf_counter()
    units = 0
    while units == 0 or time.perf_counter() - t0 < run.seconds:
        units += group(run, cell)
    return Window(units, time.perf_counter() - t0)


def traced(run, cell):
    tr = run.traffic
    counts.vae_encoder_flops("vae", _key(run.config["vae"]), tr["batch_images"], tr["height"], tr["width"])
    rows = tr["batch_images"] * warm_draws(tr) * 2
    f = 2 ** (len(run.config["vae"]["block_out_channels"]) - 1)
    counts.unet_flops("unet", _key(run.config["unet"]), rows, tr["height"] // f, tr["width"] // f, 77)

    def work() -> Window:
        t0 = time.perf_counter()
        units = 0
        with contextlib.ExitStack() as stack:
            for p in instrument(run, cell["sd"]):
                stack.enter_context(p)
            before = launches()
            for _ in range(int(run.workload["trace"]["groups"])):
                units += group(run, cell)
            run.counters.add("launches", launches() - before)
        run.counters.add("images", units)
        return Window(units, time.perf_counter() - t0)

    return work


def metrics(run, win: Window) -> Dict[str, float]:
    return {"sweep_images_per_hr": win.units / win.seconds * 3600.0}


def release(run, cell):
    cell["patch"].__exit__(None, None, None)
    out = {"grids": dict(cell["kept"]), "pool": cell["pool"], "maps": cell["maps"], "keep_uid": cell["keep_uid"]}
    cell.clear()
    free()
    return out


def reference_map(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """mean_n of (L_null - L_cond), the channel-mean losses upsampled
    bilinearly (align_corners False) to the image."""
    up = F.interpolate(grid.float().mean(dim=2), size=(h, w), mode="bilinear", align_corners=False)
    return (up[:, 1] - up[:, 0]).mean(dim=0)


def check(run, outputs, precision: str = "fp32", control: str | None = None) -> Dict[str, float]:
    from PIL import Image

    tr = run.traffic
    rng = random.Random(derive(run.seed, "check-draws"))
    idx = sorted(rng.sample(range(tr["N"]), int(run.workload["check"]["draws"])))
    models = reference_models(run, precision)
    stand_in = reference_models(run, control) if control else None
    got, want, got_map, want_map = [], [], [], []
    for uid, k in sorted(outputs["keep_uid"].items(), key=lambda kv: kv[1]):
        grid = outputs["grids"].get(uid)
        art = os.path.join(outputs["maps"], f"{k:07d}_loss_pixel.npy")
        if grid is None or not os.path.isfile(art):
            return {"losses_rel_l2": float("inf"), "map_rel_l2": float("inf")}
        path = outputs["pool"][k % len(outputs["pool"])]
        x = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0 * 2.0 - 1.0
        x = torch.from_numpy(x).permute(2, 0, 1)[None].to(run.device)
        ref = reference_losses(run, models, x, uid, tr["disease"], idx, Precision(precision)).cpu()
        want.append(ref)
        if stand_in is not None:
            alt = reference_losses(run, stand_in, x, uid, tr["disease"], idx, Precision(control)).cpu()
            got.append(alt)
            got_map.append(reference_map(alt, x.shape[2], x.shape[3]))
            want_map.append(reference_map(ref, x.shape[2], x.shape[3]))
        else:
            got.append(grid[idx].float())
            got_map.append(torch.from_numpy(np.load(art)))
            want_map.append(reference_map(grid, x.shape[2], x.shape[3]))
    del models, stand_in
    free()
    return {"losses_rel_l2": rel_l2(torch.stack(got), torch.stack(want)),
            "map_rel_l2": rel_l2(torch.stack(got_map), torch.stack(want_map))}
