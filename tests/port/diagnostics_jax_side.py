"""The JAX side of the diagnostics parity tests (test_torch_diagnostics.py),
run in a subprocess of its own:

    python tests/port/diagnostics_jax_side.py OUT_DIR

It runs the JAX package's bootstrap_training and fitting_diagnostic on the
cases below, and its cli.diagnose on every run OUT_DIR/cli_runs.json lists
(model directories and data the test wrote with the port), on the CPU in
float64, and writes OUT_DIR/jax.json.  The vmapped solves and the fitting
curves' solves compile in this process, never in the test process, where
XLA state builds up toward the JAX suite's crash.  The problem functions
are numpy only, so the test imports them to make the same inputs for the
port.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]

BOOT_N, BOOT_D = 1200, 6
# TRON stops at a gradient test of 1e-6 while its steps still reduce f by
# more than float64 rounding: near the optimum its ratio rho is rounding
# noise, and two summation orders would accept different steps
_TRON = {"optimizer": "tron", "tolerance": 1e-6}
# name -> (task, regularization, alpha, lambda, OptimizerConfig fields,
# weights, offsets, warm start, replicas)
BOOT_CASES = {
    "logistic_l2": ("logistic_regression", "l2", None, 1.0, {}, True, True, True, 5),
    "linear_elastic_net": ("linear_regression", "elastic_net", 0.5, 0.5, {},
                           True, False, False, 4),
    "poisson_tron": ("poisson_regression", "l2", None, 1.0, _TRON, False, True, True, 6),
    "hinge_box": ("smoothed_hinge_loss_linear_svm", "l2", None, 0.1,
                  {"box_lower": (-0.5,) * BOOT_D, "box_upper": (0.5,) * BOOT_D},
                  True, False, False, 4),
}
# every LBFGS/OWLQN solve converges far below the 1e-8 the summaries are
# held to
BOOT_OPTIMIZER = {"max_iterations": 200, "tolerance": 1e-11}
# name -> (task, regularization, lambda, OptimizerConfig fields); the
# CLI's npz GLM run draws logistic LBFGS curves with weights and offsets
FIT_CASES = {"linear_tron": ("linear_regression", "l2", 0.5, _TRON)}


def bootstrap_problem(task: str, seed: int = 3, n: int = BOOT_N, d: int = BOOT_D) -> dict:
    """x [n, d] (intercept last), labels from a planted GLM of `task`,
    weights in [0.5, 2], offsets, a warm start."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    z = x @ (rng.normal(size=d) * (0.3 if task == "poisson_regression" else 1.0))
    if task == "linear_regression":
        y = z + rng.normal(size=n)
    elif task == "poisson_regression":
        y = rng.poisson(np.exp(z)).astype(np.float64)
    else:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return dict(x=x, labels=y, weights=rng.uniform(0.5, 2.0, size=n),
                offsets=rng.normal(size=n) * 0.2, warm_start=rng.normal(size=d) * 0.1)


def optimizer_fields(fields: dict, OptimizerType) -> dict:
    out = dict(BOOT_OPTIMIZER, **fields)
    if "optimizer" in out:
        out["optimizer"] = OptimizerType(out["optimizer"])
    return out


def bootstrap_kwargs(case: str, OptimizerConfig, OptimizerType, RegularizationContext,
                     RegularizationType) -> dict:
    """bootstrap_training's keyword arguments of a case; pass either
    package's classes."""
    task, reg, alpha, lam, opt, w, o, warm, k = BOOT_CASES[case]
    p = bootstrap_problem(task)
    return dict(
        num_bootstrap_samples=k, weights=p["weights"] if w else None,
        offsets=p["offsets"] if o else None,
        optimizer_config=OptimizerConfig(**optimizer_fields(opt, OptimizerType)),
        regularization=RegularizationContext(RegularizationType(reg), alpha),
        regularization_weight=lam, warm_start=p["warm_start"] if warm else None, seed=11)


def fitting_kwargs(case: str, OptimizerConfig, OptimizerType, RegularizationContext,
                   RegularizationType) -> dict:
    task, reg, lam, opt = FIT_CASES[case]
    p = bootstrap_problem(task, seed=4)
    return dict(weights=p["weights"], offsets=p["offsets"],
                optimizer_config=OptimizerConfig(**optimizer_fields(opt, OptimizerType)),
                regularization=RegularizationContext(RegularizationType(reg)),
                regularization_weight=lam, seed=5)


def _classes():
    from photon_ml_tpu.optim import (OptimizerConfig, OptimizerType, RegularizationContext,
                                     RegularizationType)
    return OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType


# the JAX CLI's Avro read keeps float32 features under --x64, and its
# bootstrap and learning curves keep that dtype; for these runs they get
# the shard widened to float64, the precision the port's CLI casts it to
# (the feature statistics stay on the read's float32 in both packages)
WIDENED_RUNS = ("glm_avro_full",)


@contextlib.contextmanager
def _widened_fits():
    from photon_ml_tpu import diagnostics
    saved = diagnostics.bootstrap_training, diagnostics.fitting_diagnostic

    def widened(fn):
        return lambda x, *args, **kwargs: fn(np.asarray(x, dtype=np.float64),
                                             *args, **kwargs)
    diagnostics.bootstrap_training, diagnostics.fitting_diagnostic = map(widened, saved)
    try:
        yield
    finally:
        diagnostics.bootstrap_training, diagnostics.fitting_diagnostic = saved


def _run(out_dir: Path) -> dict:
    from photon_ml_tpu.cli import diagnose
    from photon_ml_tpu.diagnostics import bootstrap_training, fitting_diagnostic
    out = {"bootstrap": {}, "fitting": {}, "cli": {}, "errors": {}}
    for case, spec in BOOT_CASES.items():
        p = bootstrap_problem(spec[0])
        rep = bootstrap_training(p["x"], p["labels"], spec[0],
                                 **bootstrap_kwargs(case, *_classes()))
        out["bootstrap"][case] = dict(rep.to_dict(),
                                      significant_mask=rep.significant_mask.tolist())
    for case, spec in FIT_CASES.items():
        p = bootstrap_problem(spec[0], seed=4)
        rep = fitting_diagnostic(p["x"], p["labels"], spec[0],
                                 **fitting_kwargs(case, *_classes()))
        out["fitting"][case] = rep.to_dict()
    p = bootstrap_problem("linear_regression", n=20, d=2)
    for name, kw in (("one_sample", {"num_bootstrap_samples": 1}),
                     ("portion", {"training_portion": 1.5})):
        try:
            bootstrap_training(p["x"], p["labels"], "linear_regression", **kw)
        except ValueError as e:
            out["errors"][name] = str(e)
    for name, argv in json.loads((out_dir / "cli_runs.json").read_text()).items():
        stdout = io.StringIO()
        widened = _widened_fits() if name in WIDENED_RUNS else contextlib.nullcontext()
        with widened, contextlib.redirect_stdout(stdout):
            rc = diagnose.main(argv + ["--output-dir", str(out_dir / "jax" / name), "--x64"])
        out["cli"][name] = {"rc": rc, "stdout": stdout.getvalue().strip().splitlines()[-1]}
    return out


def run_jax_side(out_dir: Path) -> dict:
    """Run this script on `out_dir` in a fresh process; its results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(out_dir)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side failed:\n{proc.stderr[-4000:]}")
    return json.loads((out_dir / "jax.json").read_text())


def main(argv) -> int:
    out_dir = Path(argv[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    (out_dir / "jax.json").write_text(json.dumps(_run(out_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
