"""The port stands alone: no module of ``repro_torch`` imports JAX or the
JAX package, and its entry points run on the card unless asked for the
CPU."""
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def _modules():
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_no_module_imports_jax_or_repro():
    offenders = []
    for f in sorted(PKG.rglob("*.py")):
        for m in FORBIDDEN.finditer(f.read_text()):
            offenders.append(f"{f.relative_to(SRC)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_kernels_import_nothing_of_the_models():
    """The kernels take the tuning knobs as arguments: no module of
    ``repro_torch.kernels`` imports ``repro_torch.models`` (whose
    ``tuning.ACTIVE`` is process-global state)."""
    upward = re.compile(r"^\s*(?:import|from)\s+repro_torch\.models\b", re.M)
    offenders = [f"{f.relative_to(SRC)}: {m.group(0).strip()}"
                 for f in sorted((PKG / "kernels").rglob("*.py"))
                 for m in upward.finditer(f.read_text())]
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_repro_blocked():
    """Import each module in a fresh interpreter where ``jax`` and ``repro``
    cannot be imported."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " and sys.modules[m] is not None]\n"
        "assert not leaked, leaked\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch):
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(get_smoke_config("llama-13b"), {}, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    assert resolve_device("cpu").type == "cpu"


def test_whatif_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``evaluate``/``run_sweep`` default to the torch backend on the card,
    and without CUDA they raise before any replay, never run on the host."""
    import torch

    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import DownscalePolicy, evaluate, run_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = TelemetryStore(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate([DownscalePolicy()], store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sweep(store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate([DownscalePolicy()], store, backend="auto")


def test_resolve_backend():
    from repro_torch.whatif.sweep import resolve_backend

    assert resolve_backend("auto") == "torch"
    assert resolve_backend("torch") == "torch"
    assert resolve_backend("numpy") == "numpy"
    for bad in ("jax", "tpu", "cuda"):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(bad)


#: the scripts at the root of the repository that drive the port on the card
SCRIPTS = ("chip_smoke.py", "attention_sweep.py", "recurrent_decode.py",
           "cap_scan_buckets.py", "recurrent_backward.py")


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_no_jax_or_repro(script):
    text = (SRC.parent / script).read_text()
    assert not FORBIDDEN.findall(text), script


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_exit_2_without_cuda(script, tmp_path):
    """Without a card the scripts print no result and exit 2 (a CPU-only
    torch reports no CUDA)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without a CUDA device")
    out = subprocess.run([sys.executable, str(SRC.parent / script)],
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 2, out.stderr
    assert '"ok"' not in out.stdout


def test_dryrun_makes_every_float_tensor_on_meta(monkeypatch):
    """The dry-run needs no card and allocates nothing: with CUDA reported
    absent, every floating-point tensor a cell's ops make (parameters,
    optimizer state, caches, activations, gradients) lies on ``meta``, on a
    world of one and on the fake 16 x 16 mesh."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch import dryrun

    devices = set()

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            devices.update(t.device.type for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor) and t.is_floating_point())
            return out

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with Devices():
        for world, shape in (((1, 1), "train:2x16"), (None, "train:32x16"),
                             ((1, 1), "decode:2x16")):
            r = dryrun.run_cell("hymba-1.5b", shape, False, world=world, smoke=True)
            assert r["status"] == "ok", r.get("traceback")
    assert devices == {"meta"}
    assert "The only device is ``meta``" in " ".join(dryrun.__doc__.split())
