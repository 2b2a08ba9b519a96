"""The port stands alone: no JAX and nothing of psa_tpu in psa_torch or
chip_smoke.py, entry points that refuse to run on the CPU unless asked, and
a kernel wrapper that counts only real launches."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_torch.core.tables import build_tables
from psa_torch.models import search as search_mod
from psa_torch.ops import sweep as sw
from psa_torch.utils import cli

ROOT = Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|psa_tpu)\b", re.M)


def test_import_leaves_no_jax_or_psa_tpu():
    code = ("import sys, psa_torch, psa_torch.utils.cli, psa_torch.models.batch, "
            "psa_torch.utils.pretty, psa_torch.utils.generator, psa_torch.config, "
            "psa_torch.ops._sweep_v2, psa_torch.ops._sweep_v3, "
            "psa_torch.utils.kernel_lab, psa_torch.utils.lab_ab, psa_torch.native, "
            "psa_torch.utils.server, psa_torch.utils.io, psa_torch.parallel.mesh, "
            "psa_torch.parallel.multihost, psa_torch.utils.launcher, "
            "psa_torch.ops.engine_xla, psa_torch.ops.engine_conv, "
            "psa_torch.utils.profiling, psa_torch.ops.epilogue; "
            "assert psa_torch.native.available(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'psa_tpu')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_static_scan_finds_no_jax_or_psa_tpu_import():
    files = sorted(f for f in (ROOT / "psa_torch").rglob("*.py")
                   if "_build" not in f.relative_to(ROOT).parts)
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
              ROOT / "examples" / "library_usage_torch.py"]
    assert len(files) > 10
    for f in ("models/batch.py", "ops/_sweep_v2.py", "ops/_sweep_v3.py",
              "utils/kernel_lab.py", "utils/lab_ab.py", "native/__init__.py",
              "utils/server.py", "utils/io.py", "utils/cli.py",
              "parallel/mesh.py", "parallel/multihost.py", "utils/launcher.py",
              "ops/engine_xla.py", "ops/engine_conv.py", "utils/profiling.py",
              "ops/epilogue.py"):
        assert ROOT / "psa_torch" / f in files
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        search_mod.AlignmentSearchEngine((1, 3, 4, 2), False)
    with pytest.raises(RuntimeError):
        search_mod.search("ABCDEFG", "ABC", (1, 3, 4, 2), False)
    inp = tmp_path / "in.txt"
    inp.write_text("1 3 4 2 ABCDEFGH CDE minimum\n")
    assert cli.main([str(inp), "-o", str(tmp_path / "o.txt"), "--quiet"]) == 2
    assert not (tmp_path / "o.txt").exists()
    # the host oracle needs no card
    search_mod.AlignmentSearchEngine((1, 3, 4, 2), False, backend="numpy")


def test_native_source_is_the_jax_package_copy():
    """The port builds its own copy of the C++ host engine, byte for byte
    the JAX package's."""
    port = ROOT / "psa_torch" / "native" / "psa_native.cpp"
    assert port.read_bytes() == (ROOT / "psa_tpu" / "native" / "psa_native.cpp").read_bytes()
    from psa_torch import native

    assert Path(native._SRC) == port


@pytest.mark.parametrize("backend", ["auto", "hybrid"])
def test_device_backends_without_cuda_raise(monkeypatch, backend):
    """`auto` and `hybrid` run their device half on the card: without one
    they raise, whatever the query's size, unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        search_mod.AlignmentSearchEngine((1, 3, 4, 2), False, backend=backend)
    eng = search_mod.AlignmentSearchEngine((1, 3, 4, 2), False, backend=backend,
                                           device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.search("ABCDEFGHIJ", "CDE").offset >= 0
    # the host engines need no card
    assert search_mod.AlignmentSearchEngine((1, 3, 4, 2), False,
                                            backend="native").device is None


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    t = build_tables(np.array([1.0, 3.0, 4.0, 2.0]), False)
    before = sw.launches
    counts, maxrank = sw.offset_stats(np.arange(26, dtype=np.int32).repeat(40),
                                      np.arange(20, dtype=np.int32), t, "cpu")
    assert counts.shape == (26 * 40 - 20 + 1, 4) and maxrank.max() >= 0
    assert sw.launches == before


def test_library_build_is_deferred():
    """Importing the sweep and epilogue modules builds nothing: the library
    is compiled at the first CUDA launch."""
    out = subprocess.run([sys.executable, "-c", "import psa_torch.ops.sweep as s, "
                          "psa_torch.ops.epilogue as e; "
                          "print(s._lib is None, s.launches, e.launches)"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "0", "0"], out.stderr


def test_epilogue_source_is_the_ports_own():
    """csrc/epilogue.cu is built with the sweeps (one nvcc per csrc/*.cu,
    hashed into the library's name) and names nothing of the JAX package
    but the function it replaces."""
    src = ROOT / "psa_torch" / "csrc" / "epilogue.cu"
    assert src in set(sw._CSRC.glob("*.cu"))
    text = src.read_text()
    assert "#include" in text and not re.search(r"#include\s+[<\"](jax|psa_tpu)", text)
    assert "psa_tpu/models/batch.py:643" in text
