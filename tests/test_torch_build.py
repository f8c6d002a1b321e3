"""The port's kernel build on the CPU, with ``nvcc`` stubbed out.

``kernels/common.py`` compiles ``csrc/*.cu`` and generated chase sources
with ``nvcc`` on the card's machine.  These tests replace the compiler
with a stub that records what it was handed, and check that a generated
source reaches it whole (written under a temporary name and renamed into
place, so a second process building the same program never hands
``nvcc`` a half-written file), that threads build two generated
sources at once and one source once, that a chase program's library
name changes with the compiler flags, and that a fixed library built
with other flags is rebuilt.
"""

import os
import subprocess
import types

import pytest

from repro_torch.compile import chase as cops
from repro_torch.kernels import common


def _program():
    return cops.trace_chase(lambda s: s[0] // 2,
                            lambda s, r: (s[0] + r[0], s[1] - 1),
                            lambda s: (s[0], s[1]), 2, 1)


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """nvcc -> a stub that reads its source argument and writes an empty
    library; loading a library returns a marker object."""
    seen = []

    def run(cmd, **kwargs):
        src = cmd[-1]
        seen.append((src, open(src).read(), list(replaced)))
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="")

    replaced = []
    real_replace = os.replace

    def replace(a, b):
        replaced.append((os.fspath(a), os.fspath(b)))
        real_replace(a, b)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(os, "replace", replace)
    monkeypatch.setattr(common, "GENERATED_DIR", tmp_path / "chase")
    monkeypatch.setattr(common, "_open", lambda path: ("loaded", path))
    monkeypatch.setattr(common, "_LIBS", {})
    return seen


def test_generated_source_reaches_nvcc_whole_through_a_rename(stub_nvcc,
                                                              tmp_path):
    prog = _program()
    name, source = prog.library_name(), prog.source()
    lib = common.load_generated(name, source)
    assert lib == ("loaded", tmp_path / "chase" / f"lib{name}.so")
    (src, text, replaced_before), = stub_nvcc
    assert src == str(tmp_path / "chase" / f"{name}.cu")
    assert text == source
    # the source was renamed into place before the compiler read it, from
    # a temporary file in the same directory
    tmp, dst = replaced_before[-1]
    assert dst == src and tmp != src
    assert os.path.dirname(tmp) == os.path.dirname(src)
    assert not os.path.exists(tmp)
    # the library exists now: a second load in a fresh process builds
    # nothing
    common._LIBS.clear()
    common.load_generated(name, source)
    assert len(stub_nvcc) == 1


def test_generated_builds_of_two_names_run_at_once(tmp_path, monkeypatch):
    """Threads building two programs run two compilers at once; threads
    asking for one program build it once and all get it."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor
    active, peak, calls = [0], [0], []
    lock = threading.Lock()

    def run(cmd, **kwargs):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            calls.append(cmd[-1])
        time.sleep(0.3)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        with lock:
            active[0] -= 1
        return types.SimpleNamespace(returncode=0, stdout="")

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(common, "GENERATED_DIR", tmp_path / "chase")
    monkeypatch.setattr(common, "_open", lambda path: ("loaded", path))
    monkeypatch.setattr(common, "_LIBS", {})
    names = ["chase_a", "chase_b", "chase_a", "chase_b", "chase_a"]
    with ThreadPoolExecutor(len(names)) as pool:
        futures = [pool.submit(common.load_generated, n, f"// {n}\n")
                   for n in names]
        libs = [f.result(timeout=30) for f in futures]
    assert peak[0] == 2 and len(calls) == 2
    assert libs == [("loaded", tmp_path / "chase" / f"lib{n}.so")
                    for n in names]


def test_chase_library_name_hashes_the_compiler_flags(monkeypatch):
    prog = _program()
    before = prog.library_name()
    assert prog.library_name() == before
    monkeypatch.setattr(common, "NVCC_FLAGS",
                        (*common.NVCC_FLAGS, "-lineinfo"))
    assert prog.library_name() != before


def test_fixed_library_rebuilds_when_the_flags_change(tmp_path,
                                                      monkeypatch):
    src = common.CSRC / "dae_gather.cu"
    lib = tmp_path / "libdae_gather.so"
    assert common._stale(src, lib)                  # missing
    lib.write_bytes(b"")
    os.utime(lib, (2e9, 2e9))                       # newer than sources
    assert common._stale(src, lib)                  # no flag stamp
    common._write_whole(common._stamp(lib), common._flags())
    assert not common._stale(src, lib)
    monkeypatch.setattr(common, "NVCC_FLAGS",
                        (*common.NVCC_FLAGS, "-lineinfo"))
    assert common._stale(src, lib)
