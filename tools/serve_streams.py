#!/usr/bin/env python3
"""Hold this tree's full-width token streams to other checkouts', in one
call.

    git archive <commit> | tar -x -C build/parent
    python3 tools/serve_streams.py build/parent [...]

Each side serves ``chip_smoke.py``'s phase-5 requests (8 prompts of
1-700 tokens, 32 new each; 8 slots, s_max 1024, page 16, chunk 32) with
seeded full-width weights, in a process of its own from its checkout's
root (its own ``src/`` and ``build/``): granite-moe-3b-a800m through
``PagedServeLoop``, qwen3-4b and deepseek-v2-lite-16b through
``PagedServeLoop`` and ``ServeLoop``, minicpm3-4b through
``PagedServeLoop``.  It prints each path's wall per side and, per path,
how many of the 8 streams equal this tree's; it exits 1 if any differs.
It prints the card's name and power limit; it needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
RUN = """
import json, sys, torch
import chip_smoke as cs
from repro_torch.kernels.common import build_kernels
from repro_torch.runtime.serve_loop import PagedServeLoop, ServeLoop
build_kernels()
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
streams = {}
for arch, loops in ((cs.GRANITE, ("paged",)), (cs.QWEN, ("paged", "contig")),
                    (cs.MINICPM, ("paged",)),
                    (cs.DEEPSEEK, ("paged", "contig"))):
    cfg, bundle, params = cs.build_full(arch, dev)
    for name in loops:
        _, reqs = cs.main_requests(cfg.vocab)
        if name == "paged":
            loop = PagedServeLoop(cfg, bundle, params, batch_slots=cs.SLOTS,
                                  s_max=cs.S_MAX, chunk=cs.CHUNK,
                                  page=cs.PAGE)
        else:
            loop = ServeLoop(cfg, bundle, params, batch_slots=cs.SLOTS,
                             s_max=cs.S_MAX, chunk=cs.CHUNK)
        res, wall = cs.serve(loop, reqs)
        streams[f"{arch} {name}"] = {str(k): [int(t) for t in v]
                                     for k, v in res.items()}
        print(f"{arch} {name}: {wall:.2f} s", flush=True)
        del loop
    del params, bundle
    torch.cuda.empty_cache()
json.dump(streams, open(sys.argv[1], "w"))
"""


def run(root: Path) -> dict:
    """One side's streams: {path: {request: tokens}}."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "streams.json"
        env = dict(os.environ, PYTHONPATH=str(root / "src"),
                   REPRO_TUNE_CACHE=str(Path(tmp) / "tune_cache.json"))
        proc = subprocess.run([sys.executable, "-c", RUN, str(out)],
                              cwd=root, env=env, capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"{root}: exited {proc.returncode}\n"
                               f"{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if line.endswith(" s"):
                print(f"  {line}", flush=True)
        return json.loads(out.read_text())


def main() -> int:
    others = [Path(p).resolve() for p in sys.argv[1:]]
    if not others:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"{THIS}:", flush=True)
    mine = run(THIS)
    differ = False
    for other in others:
        print(f"{other}:", flush=True)
        theirs = run(other)
        for path, streams in mine.items():
            same = sum(theirs.get(path, {}).get(rid) == toks
                       for rid, toks in streams.items())
            differ |= same != len(streams)
            print(f"{path}: {same}/{len(streams)} streams equal to "
                  f"{other.name}'s", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
