#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s serve walls of this tree against other
checkouts', in one call.

    git archive <commit> | tar -x -C build/parent
    python3 tools/serve_ab.py build/parent [...]

Each side runs phase 5's qwen3-4b paths (``run_qwen``: ``PagedServeLoop``,
the repeated prompt, ``ServeLoop``) and deepseek-v2-lite-16b's
(``run_mla``: both loops and the prefill step) in a process of its own,
from its checkout's root, so that it imports that checkout's ``src/`` and
builds its kernels into that checkout's ``build/``; the tune cache
points at an empty file, so every side runs its analytic knobs.  The
order is other, this, this, other (for each other checkout given).  It
prints each run's serve lines and then, per path, each side's walls and
their mean.  It prints the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
RUN = """
import torch
import chip_smoke as cs
from repro_torch.kernels.common import build_kernels
build_kernels()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
card = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
launches = cs.Launches()
cs.run_qwen(dev, launches, card)
torch.cuda.empty_cache()
cs.run_mla(dev, launches, card, cs.DEEPSEEK, "deepseek")
"""
# "<arch> <loop>: 256 tokens, ... <wall> s" and the repeat's wall
WALL = re.compile(r"^(\S+) (PagedServeLoop|ServeLoop): \d+ tokens, .*?"
                  r"(\d+\.\d+) s[;,]")
REPEAT = re.compile(r"^(\S+) .*?repeat of a \d+-token prompt (\d+\.\d+) s")


def run(root: Path):
    """One side's serve walls: {path: seconds}."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(root / "src"),
                   REPRO_TUNE_CACHE=str(Path(tmp) / "tune_cache.json"))
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env,
                              capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{root}: exited {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    walls = {}
    for line in proc.stdout.splitlines():
        m, r = WALL.match(line), REPEAT.match(line)
        if m:
            walls[f"{m.group(1)} {m.group(2)}"] = float(m.group(3))
        if r:
            walls[f"{r.group(1)} repeat"] = float(r.group(2))
        if m or r:
            print(f"  {line[:160]}", flush=True)
    return walls


def main() -> int:
    others = [Path(p).resolve() for p in sys.argv[1:]]
    if not others:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sides = defaultdict(lambda: defaultdict(list))
    for other in others:
        for root in (other, THIS, THIS, other):
            print(f"{root}:", flush=True)
            for path, wall in run(root).items():
                sides[path][str(root)].append(wall)
    for path, by_root in sides.items():
        cells = "; ".join(f"{root}: {' '.join(f'{w:.2f}' for w in ws)} s "
                          f"(mean {sum(ws) / len(ws):.2f})"
                          for root, ws in by_root.items())
        print(f"{path}: {cells}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
