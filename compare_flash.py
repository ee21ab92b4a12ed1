#!/usr/bin/env python3
"""Time the flash kernels of two checkouts on one card, in turns.

    python3 compare_flash.py OTHER_TREE [--out FILE]

OTHER_TREE is another checkout of this repository (for example a parent
commit unpacked with ``git archive <commit> | tar -x -C build/parent``).
The two trees run in the order other, this, this, other, each in a process
of its own that puts the tree's ``src`` and its ``chip_smoke.py`` first on
``sys.path`` and builds the tree's kernels into the tree's own ``build/``.
Each run holds and times every f32 flash forward and backward row of
``chip_smoke.py`` phase 3 (smollm-360m's, nemotron-4-340b's, mixtral's
ring check, jamba's check, whisper-large-v3's) with that tree's own
``check_flash`` / ``check_flash_bwd``: the kernel against its plain version
at the tree's limits, its time (CUDA events, median of 30, L2 flushed),
its kernels' device time, SDPA's time and the bound. One JSON line per row
and run goes to stdout and to ``FILE`` (default
``build/compare_flash.jsonl``, git-ignored); the card's name and power
limit first. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEEP = ("ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "bound_fp32_fma_ms", "max_abs_err", "err_over_tol_by_grad", "kernel", "kv_split")


def cases(cs) -> list[tuple[str, tuple, dict]]:
    """The f32 flash rows of phase 3, with the tree's own constants."""
    import torch

    f32 = torch.float32
    nemotron = {"H": cs.NEMOTRON_H, "K": cs.NEMOTRON_K, "hd": 192}
    mixtral = {"H": cs.MIXTRAL_H, "K": cs.MIXTRAL_K, "hd": 128}
    jamba = {"H": cs.JAMBA_H, "K": cs.JAMBA_K, "hd": 128}
    whisper = {"H": cs.WHISPER_H, "K": cs.WHISPER_H, "hd": 64}
    frames = {"rms_tol": cs.WHISPER_RMS_TOL, **whisper}
    F_ = cs.WHISPER_FRAMES
    rows = [("fwd", (f32, 2, S, True, window), {})
            for S, window in ((512, None), (1024, None), (1000, None), (1024, 256))]
    rows += [("fwd", (f32, 1, 2048, True, None), nemotron),
             ("fwd", (f32, 2, cs.MIXTRAL_RING_POSITIONS, True, cs.MIXTRAL_RING_WINDOW), mixtral),
             ("fwd", (f32, 2, 64, True, None), jamba),
             ("fwd", (f32, 2, F_, False, None), frames)]
    rows += [("fwd", (f32, 2, Sq, False, None), {"Skv": F_, **frames}) for Sq in (512, 37, 1)]
    rows += [("fwd", (f32, 2, 64, True, None), whisper)]
    rows += [("bwd", (f32, B, S, True, window), {})
             for B, S, window in ((cs.TRAIN_B, cs.TRAIN_S, None), (2, 1000, None),
                                  (2, 1024, 256))]
    rows += [("bwd", (f32, 1, 512, True, None), nemotron),
             ("bwd", (f32, cs.WHISPER_TRAIN_B, F_, False, None), whisper),
             ("bwd", (f32, cs.WHISPER_TRAIN_B, cs.WHISPER_TRAIN_S, False, None),
              {"Skv": F_, **whisper})]
    return rows


def run_tree(tree: Path, label: str, rep: int) -> None:
    """One run of every row on ``tree``'s kernels; JSON lines to stdout."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
    for kind, args, kw in cases(cs):
        check = cs.check_flash if kind == "fwd" else cs.check_flash_bwd
        rec = check(ops, ref, timer, dev, *args, **kw)
        print(json.dumps({"tree": label, "run": rep, "kind": kind, "shape": rec["shape"],
                          **{k: rec[k] for k in KEEP if k in rec}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "compare_flash.jsonl")
    ap.add_argument("--run-tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--rep", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run_tree:
        run_tree(a.run_tree.resolve(), a.label, a.rep)
        return 0
    import torch

    if not torch.cuda.is_available() or a.other is None:
        print("compare_flash: needs a CUDA card and another tree", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    a.out.parent.mkdir(parents=True, exist_ok=True)
    with open(a.out, "w") as out:
        out.write(json.dumps({"nvidia_smi": smi}) + "\n")
        print(smi, flush=True)
        trees = {"other": a.other.resolve(), "this": ROOT}
        for rep, label in enumerate(("other", "this", "this", "other")):
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run-tree",
                                   str(trees[label]), "--label", label, "--rep", str(rep)],
                                  cwd=trees[label], capture_output=True, text=True, timeout=1800)
            sys.stdout.write(proc.stdout)
            out.write(proc.stdout)
            out.flush()
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
