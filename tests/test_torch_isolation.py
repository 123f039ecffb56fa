"""The port stands alone: ``repro_torch`` imports neither JAX nor the
reference package, and its entry points default to the CUDA card without
falling back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_every_module_imports_with_jax_and_reference_blocked():
    """A subprocess that makes ``import jax`` and ``import repro`` fail can
    still import every port module."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(MODULES) >= 20


def test_the_overlay_and_obs_modules_are_covered():
    """The import check above walks the whole package: the overlay and the
    metrics module it records into are among the modules it imports."""
    for mod in ("repro_torch.overlay", "repro_torch.overlay.delta", "repro_torch.overlay.views",
                "repro_torch.overlay.compactor", "repro_torch.obs", "repro_torch.obs.metrics"):
        assert mod in MODULES, mod


def test_no_port_source_names_jax_or_the_reference():
    """Neither the package nor the on-card smoke script (``chip_smoke.py``)."""
    pattern = re.compile(r"\bjax\b|\bjaxlib\b|\brepro\.|from repro import|import repro\b")
    offenders = [f"{p.relative_to(SRC.parent)}:{i}: {line.strip()}"
                 for p in [*PORT.rglob("*.py"), SRC.parent / "chip_smoke.py"]
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pattern.search(line)]
    assert not offenders, offenders


def test_propgraph_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from repro_torch.core import PropGraph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PropGraph()
    with pytest.raises(RuntimeError, match="CUDA"):
        PropGraph(backend="arr")
    assert PropGraph(device="cpu").device.type == "cpu"



def test_build_di_host_input_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    """Host endpoints (numpy, lists) with no ``device`` go to the card, as
    ``PropGraph`` does; a tensor keeps its device."""
    import numpy as np

    from repro_torch.core import di

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = np.array([3, 1, 2]), np.array([1, 2, 3])
    for a, b in ((src, dst), (src.tolist(), dst.tolist())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            di.build_di(a, b)
    assert di.build_di(torch.from_numpy(src), torch.from_numpy(dst)).device.type == "cpu"
    assert di.build_di(src, dst, device="cpu").device.type == "cpu"


def test_build_dip_arr_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from repro_torch.core import dip_arr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dip_arr.build_dip_arr([0, 5], [1, 0], k=2, n=6)
    assert dip_arr.build_dip_arr([0, 5], [1, 0], k=2, n=6, device="cpu").bitmap.device.type == "cpu"


def test_resolve_device_keeps_its_old_import_path():
    from repro_torch.core import device, property_graph

    assert property_graph.resolve_device is device.resolve_device
