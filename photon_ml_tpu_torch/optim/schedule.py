"""Inexact inner-solve budgets for block coordinate descent (port of
photon_ml_tpu/optim/schedule.py).

The GAME outer loop re-perturbs every coordinate's problem on the next
visit, so paying full-tolerance convergence on early visits is wasted work.
Running inner solves inexactly early and tightening geometrically toward
the end is the standard cure (Trofimov & Genkin, arXiv:1611.02101; Snap
ML's hierarchical local solvers, arXiv:1803.06333).

Two pieces:

  * `SolveBudget`: an (iteration cap, tolerance) pair.  The JAX package
    traces it into its compiled solvers as operands; the port's solvers are
    host-stepped, so here it is a plain int and float.  The solvers'
    history buffers stay sized by `max_iterations` and only the loop bound
    uses the cap, so histories keep the JAX package's shapes under a cap.
  * `SolverSchedule`: the per-outer-iteration policy: small caps and a
    loose tolerance on early outer iterations, geometric growth and
    tightening, and the FINAL outer iteration always at the full configured
    budget, so the scheduled fit's final objective matches a strict
    full-solve fit within the parity gate.

The schedule is pure host arithmetic in (outer_iteration,
num_outer_iterations): checkpoint resume recomputes identical budgets for
the remaining iterations, so a resumed scheduled fit reproduces the
uninterrupted trajectory.

The stochastic-lane and ADMM fields are parsed, validated and written back
as the JAX package writes them; a resident coordinate ignores them, as in
JAX (their lanes are ROADMAP.md queue A items 16 part 2 and 20).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StochasticPlan:
    """One outer iteration's budget for the stochastic streaming lane: full
    passes over the chunk stream, local coordinate-descent epochs per
    staged chunk, and how per-chunk models merge ("sequential": chunk k
    warm-starts from chunk k-1; "average": a row-weighted average of the
    per-chunk deltas).  `step_clip` bounds each per-coordinate step for
    losses without a global curvature bound; None resolves per loss."""

    passes: int = 1
    local_epochs: int = 4
    merge: str = "sequential"
    seed: int = 0
    step_clip: Optional[float] = None

    def __post_init__(self):
        if self.passes < 0:
            raise ValueError("passes must be >= 0")
        if self.local_epochs < 1:
            raise ValueError("local_epochs must be >= 1")
        if self.merge not in ("sequential", "average"):
            raise ValueError(f"merge must be 'sequential' or 'average', "
                             f"got {self.merge!r}")


class SolveBudget(NamedTuple):
    """An inner-solve budget: the iteration cap (clipped by the solver to
    its configured max_iterations) and the tolerance."""

    iteration_cap: int
    tolerance: float

    @staticmethod
    def make(iteration_cap: int, tolerance: float) -> "SolveBudget":
        return SolveBudget(int(iteration_cap), float(tolerance))

    def tolerance_in(self, dtype: torch.dtype) -> float:
        """The tolerance rounded to the solve's dtype, as the JAX package
        makes it an operand of its default float dtype (float32 without
        x64), so an f32 fit stops on the same steps."""
        return float(torch.tensor(self.tolerance, dtype=dtype))


class RegWeights(NamedTuple):
    """Both penalty weights as tensors: a solve that takes a RegWeights
    uses them as given instead of splitting a total weight with
    `reg.split`.  The structural choice stays with the context:
    `RegularizationContext.has_l1` decides whether OWLQN runs, and an l1
    weight handed to a solve whose context has no L1 is ignored."""

    l1_weight: torch.Tensor
    l2_weight: torch.Tensor

    @staticmethod
    def make(l1_weight, l2_weight, dtype=None) -> "RegWeights":
        return RegWeights(torch.as_tensor(l1_weight, dtype=dtype),
                          torch.as_tensor(l2_weight, dtype=dtype))

    @staticmethod
    def from_context(reg, reg_weight, elastic_net_alpha=None,
                     dtype=None) -> "RegWeights":
        """Split a total weight as `reg.split` would, or with the mixing
        ratio `elastic_net_alpha` given (`l1 = a*w`, `l2 = (1-a)*w`)."""
        w = torch.as_tensor(reg_weight, dtype=dtype)
        if elastic_net_alpha is None:
            l1, l2 = reg.split(w)
            return RegWeights(torch.as_tensor(l1, dtype=w.dtype),
                              torch.as_tensor(l2, dtype=w.dtype))
        a = torch.as_tensor(elastic_net_alpha, dtype=w.dtype)
        return RegWeights(a * w, (1.0 - a) * w)


@dataclasses.dataclass(frozen=True)
class SolverSchedule:
    """Per-(outer-iteration) inexactness schedule for the inner solvers.

    On outer iteration t of N:
      - t == N-1 (final): the full configured (max_iterations, tolerance),
        so parity with a strict full-solve fit holds by construction;
      - t < N-1: iteration cap = initial_iterations * iteration_growth**t
        (clipped to the configured max_iterations) and tolerance =
        configured_tolerance * initial_tolerance_factor * tolerance_decay**t
        (floored at the configured tolerance).

    Applied uniformly to fixed-effect, random-effect and factored
    coordinates (both the latent-space and the projection solves).  The
    stochastic fields configure the streamed lane and the ADMM field the
    feature-axis lane; resident coordinates ignore them.
    """

    initial_iterations: int = 4
    iteration_growth: float = 2.0
    initial_tolerance_factor: float = 1e3
    tolerance_decay: float = 0.1
    # stochastic streaming lane (0 passes = disabled)
    stochastic_passes: int = 0
    stochastic_local_epochs: int = 4
    stochastic_merge: str = "sequential"
    stochastic_seed: int = 0
    stochastic_polish_iterations: int = 1
    # feature-axis ADMM lane: the monolithic polish runs only on the final
    # `admm_polish_iterations` outer iterations
    admm_polish_iterations: int = 1

    def __post_init__(self):
        if self.initial_iterations < 1:
            raise ValueError("initial_iterations must be >= 1")
        if self.iteration_growth < 1.0:
            raise ValueError("iteration_growth must be >= 1 (budgets only "
                             "tighten toward the full solve)")
        if self.initial_tolerance_factor < 1.0:
            raise ValueError("initial_tolerance_factor must be >= 1")
        if not 0.0 < self.tolerance_decay <= 1.0:
            raise ValueError("tolerance_decay must be in (0, 1]")
        if self.stochastic_passes < 0:
            raise ValueError("stochastic_passes must be >= 0")
        if self.stochastic_local_epochs < 1:
            raise ValueError("stochastic_local_epochs must be >= 1")
        if self.stochastic_merge not in ("sequential", "average"):
            raise ValueError("stochastic_merge must be 'sequential' or "
                             f"'average', got {self.stochastic_merge!r}")
        if self.stochastic_polish_iterations < 1:
            raise ValueError("stochastic_polish_iterations must be >= 1 "
                             "(the final outer iterations ALWAYS polish "
                             "with the strict solver — parity at the fixed "
                             "point depends on it)")
        if self.admm_polish_iterations < 1:
            raise ValueError("admm_polish_iterations must be >= 1 (an "
                             "ADMM-lane fit with polish enabled always "
                             "polishes its final outer iteration)")

    def plan(self, outer_iteration: int, num_outer_iterations: int,
             max_iterations: int, tolerance: float) -> Tuple[int, float]:
        """(iteration cap, tolerance) for one outer iteration."""
        if outer_iteration >= num_outer_iterations - 1:
            return max_iterations, tolerance
        cap = int(round(self.initial_iterations
                        * self.iteration_growth ** outer_iteration))
        cap = max(1, min(cap, max_iterations))
        factor = max(self.initial_tolerance_factor
                     * self.tolerance_decay ** outer_iteration, 1.0)
        return cap, tolerance * factor

    def budget_for(self, outer_iteration: int, num_outer_iterations: int,
                   optimizer_config) -> SolveBudget:
        """SolveBudget for one (outer iteration, OptimizerConfig)."""
        r = optimizer_config.resolved()
        cap, tol = self.plan(outer_iteration, num_outer_iterations,
                             r.max_iterations, r.tolerance)
        return SolveBudget.make(cap, tol)

    def stochastic_plan(self, outer_iteration: int,
                        num_outer_iterations: int
                        ) -> Optional[StochasticPlan]:
        """The stochastic lane's budget for one outer iteration, or None
        when the strict solver should run: lane disabled, or one of the
        final `stochastic_polish_iterations` outer iterations."""
        if self.stochastic_passes <= 0:
            return None
        polish_from = num_outer_iterations - self.stochastic_polish_iterations
        if outer_iteration >= polish_from:
            return None
        return StochasticPlan(passes=self.stochastic_passes,
                              local_epochs=self.stochastic_local_epochs,
                              merge=self.stochastic_merge,
                              seed=self.stochastic_seed)

    def admm_polish(self, outer_iteration: int,
                    num_outer_iterations: int) -> bool:
        """Whether an ADMM-lane visit on this outer iteration runs the
        monolithic polish (only the final `admm_polish_iterations` do)."""
        polish_from = num_outer_iterations - self.admm_polish_iterations
        return outer_iteration >= polish_from

    # -- JSON round-trip (game/config.py embeds schedules in model metadata)
    def to_dict(self) -> dict:
        d = {"initial_iterations": self.initial_iterations,
             "iteration_growth": self.iteration_growth,
             "initial_tolerance_factor": self.initial_tolerance_factor,
             "tolerance_decay": self.tolerance_decay}
        # stochastic keys encode only when the lane is enabled, so the
        # checkpoint fingerprints of strict-only schedules stay the same
        if self.stochastic_passes > 0:
            d.update({
                "stochastic_passes": self.stochastic_passes,
                "stochastic_local_epochs": self.stochastic_local_epochs,
                "stochastic_merge": self.stochastic_merge,
                "stochastic_seed": self.stochastic_seed,
                "stochastic_polish_iterations":
                    self.stochastic_polish_iterations,
            })
        if self.admm_polish_iterations != 1:
            d["admm_polish_iterations"] = self.admm_polish_iterations
        return d

    @staticmethod
    def from_dict(d) -> "SolverSchedule | None":
        if d is None:
            return None
        return SolverSchedule(
            initial_iterations=d.get("initial_iterations", 4),
            iteration_growth=d.get("iteration_growth", 2.0),
            initial_tolerance_factor=d.get("initial_tolerance_factor", 1e3),
            tolerance_decay=d.get("tolerance_decay", 0.1),
            stochastic_passes=d.get("stochastic_passes", 0),
            stochastic_local_epochs=d.get("stochastic_local_epochs", 4),
            stochastic_merge=d.get("stochastic_merge", "sequential"),
            stochastic_seed=d.get("stochastic_seed", 0),
            stochastic_polish_iterations=d.get(
                "stochastic_polish_iterations", 1),
            admm_polish_iterations=d.get("admm_polish_iterations", 1))


@dataclasses.dataclass(frozen=True)
class QuarantineRetrySchedule:
    """The single-solve budget of a quarantine re-run (game/quarantine.py):
    a diverged quasi-Newton solve is usually a line-search or curvature
    pathology that more iterations make worse, so the one retry runs at a
    quarter of the configured iteration cap with a 10x looser tolerance.
    Duck-types SolverSchedule's `plan`/`budget_for`, so it rides the
    Coordinate.update(schedule=...) plumbing."""

    cap_divisor: int = 4
    tolerance_factor: float = 10.0

    def plan(self, outer_iteration: int, num_outer_iterations: int,
             max_iterations: int, tolerance: float) -> Tuple[int, float]:
        return (max(1, max_iterations // self.cap_divisor),
                tolerance * self.tolerance_factor)

    def budget_for(self, outer_iteration: int, num_outer_iterations: int,
                   optimizer_config) -> SolveBudget:
        r = optimizer_config.resolved()
        cap, tol = self.plan(outer_iteration, num_outer_iterations,
                             r.max_iterations, r.tolerance)
        return SolveBudget.make(cap, tol)
