"""The port stands alone: it imports neither jax nor photon_ml_tpu, and
importing it builds no kernel."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "photon_ml_tpu_torch"


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


# the package and the GPU smoke script, which must run where JAX is absent
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = [_module_name(p) for p in SOURCES]
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")
# modules the scan must reach, the sparse slice's among them
REQUIRED = ("photon_ml_tpu_torch.ops.features", "photon_ml_tpu_torch.ops.sparse_kernels",
            "photon_ml_tpu_torch.data.libsvm", "photon_ml_tpu_torch.convert",
            "photon_ml_tpu_torch.ops.hopper_kernels", "photon_ml_tpu_torch.utils.prng",
            "photon_ml_tpu_torch.data.samplers", "photon_ml_tpu_torch.parallel.factored",
            "photon_ml_tpu_torch.utils.durable", "photon_ml_tpu_torch.data.index_map",
            "photon_ml_tpu_torch.optim.constraints", "photon_ml_tpu_torch.data.avro_codec",
            "photon_ml_tpu_torch.data.avro_io", "photon_ml_tpu_torch.data.avro_native",
            "photon_ml_tpu_torch.data.avro_game", "photon_ml_tpu_torch.data.date_range",
            "photon_ml_tpu_torch.data.validators", "photon_ml_tpu_torch.models.validators",
            "photon_ml_tpu_torch.models.io", "photon_ml_tpu_torch.cli.index",
            "photon_ml_tpu_torch.cli.train", "photon_ml_tpu_torch.cli.score",
            "photon_ml_tpu_torch.optim.schedule", "photon_ml_tpu_torch.utils.faults",
            "photon_ml_tpu_torch.game.quarantine", "photon_ml_tpu_torch.game.coordinate_descent",
            "photon_ml_tpu_torch.data.streaming", "photon_ml_tpu_torch.ops.chunked",
            "photon_ml_tpu_torch.optim.streaming", "photon_ml_tpu_torch.optim.stochastic",
            "photon_ml_tpu_torch.store.base", "photon_ml_tpu_torch.store.handles",
            "photon_ml_tpu_torch.game.residency", "photon_ml_tpu_torch.ops.lanes",
            "photon_ml_tpu_torch.hyperparameter", "photon_ml_tpu_torch.hyperparameter.kernels",
            "photon_ml_tpu_torch.hyperparameter.slice_sampler",
            "photon_ml_tpu_torch.hyperparameter.gp", "photon_ml_tpu_torch.hyperparameter.search",
            "photon_ml_tpu_torch.hyperparameter.vectorized",
            "photon_ml_tpu_torch.hyperparameter.game_evaluation",
            "photon_ml_tpu_torch.evaluation.segmented", "photon_ml_tpu_torch.diagnostics",
            "photon_ml_tpu_torch.diagnostics.metrics", "photon_ml_tpu_torch.diagnostics.hl",
            "photon_ml_tpu_torch.diagnostics.independence",
            "photon_ml_tpu_torch.diagnostics.importance",
            "photon_ml_tpu_torch.diagnostics.bootstrap", "photon_ml_tpu_torch.diagnostics.fitting",
            "photon_ml_tpu_torch.diagnostics.report", "photon_ml_tpu_torch.cli.diagnose",
            "photon_ml_tpu_torch.telemetry", "photon_ml_tpu_torch.telemetry.core",
            "photon_ml_tpu_torch.telemetry.metrics", "photon_ml_tpu_torch.telemetry.timings",
            "photon_ml_tpu_torch.telemetry.export", "photon_ml_tpu_torch.telemetry.events",
            "photon_ml_tpu_torch.telemetry.flight",
            "photon_ml_tpu_torch.telemetry.distributed", "photon_ml_tpu_torch.utils.events",
            "photon_ml_tpu_torch.utils.locktrace", "photon_ml_tpu_torch.cli.trace",
            "photon_ml_tpu_torch.store", "photon_ml_tpu_torch.store.cold",
            "photon_ml_tpu_torch.store.entity", "photon_ml_tpu_torch.online",
            "photon_ml_tpu_torch.online.delta", "photon_ml_tpu_torch.serving",
            "photon_ml_tpu_torch.serving.scorer", "photon_ml_tpu_torch.serving.batcher",
            "photon_ml_tpu_torch.serving.metrics", "photon_ml_tpu_torch.serving.registry",
            "photon_ml_tpu_torch.serving.service", "photon_ml_tpu_torch.cli.serve",
            "photon_ml_tpu_torch.game.anchored", "photon_ml_tpu_torch.online.feedback",
            "photon_ml_tpu_torch.online.updater", "photon_ml_tpu_torch.fleet",
            "photon_ml_tpu_torch.fleet.replog", "photon_ml_tpu_torch.fleet.shards",
            "photon_ml_tpu_torch.health", "photon_ml_tpu_torch.health.config",
            "photon_ml_tpu_torch.health.calibration", "photon_ml_tpu_torch.health.drift",
            "photon_ml_tpu_torch.health.monitor", "photon_ml_tpu_torch.refit",
            "photon_ml_tpu_torch.refit.compactor", "photon_ml_tpu_torch.refit.driver",
            "photon_ml_tpu_torch.refit.trigger", "photon_ml_tpu_torch.cli.refit",
            "photon_ml_tpu_torch.fleet.replica", "photon_ml_tpu_torch.fleet.front",
            "photon_ml_tpu_torch.parallel", "photon_ml_tpu_torch.parallel.mesh",
            "photon_ml_tpu_torch.parallel.mesh_residency",
            "photon_ml_tpu_torch.parallel.multihost", "photon_ml_tpu_torch.optim.admm",
            "photon_ml_tpu_torch.parallel.fixed_effect",
            "photon_ml_tpu_torch.parallel.random_effect",
            "photon_ml_tpu_torch.analysis", "photon_ml_tpu_torch.analysis.__main__",
            "photon_ml_tpu_torch.analysis.engine", "photon_ml_tpu_torch.analysis.rules",
            "photon_ml_tpu_torch.analysis.concurrency", "photon_ml_tpu_torch.analysis.lint",
            "chip_smoke")


def test_the_scan_covers_the_port():
    assert set(REQUIRED) <= set(MODULES)
    assert (PKG / "analysis" / "baseline.json").exists()
    assert (PKG / "csrc" / "ell_sparse.cu").exists()
    assert (PKG / "csrc" / "fused_value_and_gradient_lanes.cu").exists()


def test_the_avro_decoder_is_the_ports_own():
    """The C decoder is built from the port's copy of the source into the
    port's build directory, never loaded from the JAX package, and the
    source includes only the C library."""
    from photon_ml_tpu_torch.data import avro_native
    src = PKG / "native" / "avro_decode.c"
    assert avro_native._SRC == src
    assert avro_native.library_path().parent == ROOT / "build" / "photon_ml_tpu_torch"
    text = (PKG / "data" / "avro_native.py").read_text()
    assert "libavrodec.so" not in text and "photon_ml_tpu/native" not in text
    includes = [ln.split()[1] for ln in src.read_text().splitlines()
                if ln.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes), includes


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent(f"""
        import importlib, subprocess, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None          # any import of them now fails
        def no_build(*a, **k):
            raise AssertionError("importing the port started a process")
        subprocess.Popen = no_build
        for mod in {MODULES!r}:
            importlib.import_module(mod)
        from photon_ml_tpu_torch.ops import _build
        assert _build.load_library.cache_info().currsize == 0
        print("imported", len({MODULES!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(MODULES)}" in out.stdout


@pytest.mark.parametrize("path", SOURCES, ids=MODULES)
def test_module_names_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
