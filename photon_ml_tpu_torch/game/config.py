"""Typed GAME training configuration with JSON round-trip (port of
photon_ml_tpu/game/config.py).

`to_dict`/`from_dict` read and write the same JSON as the JAX package, so a
configuration written by either package loads in the other; solver
schedules (`solver_schedule`) parse into optim/schedule.py's
SolverSchedule where the JAX package parses them, and a GLM's `admm`
block into optim/admm.py's ADMMConfig (the feature-axis consensus-ADMM
lane, consulted when `shard_features` is on and the mesh has a feature
axis wider than 1).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Union

from photon_ml_tpu_torch.data.batching import RandomEffectDataConfig
from photon_ml_tpu_torch.ops.normalization import NormalizationType
from photon_ml_tpu_torch.optim.admm import ADMMConfig
from photon_ml_tpu_torch.optim.constraints import constraints_to_json
from photon_ml_tpu_torch.optim.schedule import SolverSchedule
from photon_ml_tpu_torch.optim.config import (
    OptimizerConfig, OptimizerType, RegularizationContext, RegularizationType,
)


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfig:
    """(optimizer, regularization, weight, down-sampling)."""

    optimizer: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext()
    regularization_weight: float = 0.0
    downsampling_rate: Optional[float] = None
    # the consensus-ADMM lane's knobs (optim/admm.py), consulted only when
    # the lane is selected; None runs it with ADMMConfig() defaults
    admm: Optional[ADMMConfig] = None

    def __post_init__(self):
        if self.regularization_weight < 0:
            raise ValueError("regularization_weight must be >= 0")
        object.__setattr__(self, "regularization_weight",
                           float(self.regularization_weight))
        if self.downsampling_rate is not None and not 0 < self.downsampling_rate < 1:
            raise ValueError("downsampling_rate must be in (0, 1)")


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """One global GLM over a feature shard."""

    feature_shard: str
    optimization: GLMOptimizationConfig = GLMOptimizationConfig()
    normalization: NormalizationType = NormalizationType.NONE
    shard_features: Optional[bool] = None
    # "resident" | "streamed" | "auto"; on one card without a memory budget
    # "auto" is resident
    memory_mode: str = "auto"
    chunk_rows: Optional[int] = None
    # per-coordinate inexact-solve schedule; None = inherit the training
    # config's solver_schedule (optim/schedule.py)
    solver_schedule: Optional[SolverSchedule] = None

    def __post_init__(self):
        if self.memory_mode not in ("auto", "resident", "streamed"):
            raise ValueError(f"memory_mode must be 'auto', 'resident' or "
                             f"'streamed', got {self.memory_mode!r}")


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """Per-entity GLMs over a feature shard."""

    random_effect_type: str
    feature_shard: str
    optimization: GLMOptimizationConfig = GLMOptimizationConfig()
    active_data_upper_bound: Optional[int] = None
    passive_data_lower_bound: Optional[int] = None
    features_to_samples_ratio: Optional[float] = None
    projector: str = "index_map"
    # per-coordinate inexact-solve schedule; None = inherit the training
    # config's solver_schedule
    solver_schedule: Optional[SolverSchedule] = None

    def data_config(self, seed: int = 7,
                    keep_host_blocks: bool = False) -> RandomEffectDataConfig:
        return RandomEffectDataConfig(
            random_effect_type=self.random_effect_type,
            feature_shard=self.feature_shard,
            active_data_upper_bound=self.active_data_upper_bound,
            passive_data_lower_bound=self.passive_data_lower_bound,
            features_to_samples_ratio=self.features_to_samples_ratio,
            projector=self.projector,
            seed=seed, keep_host_blocks=keep_host_blocks)


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfig:
    """Matrix-factorized random effect: per-entity latent factors plus a
    shared latent projection matrix, refit alternately; `optimization` for
    the per-entity (latent-space) problems, `latent_optimization` for the
    projection-matrix problem (reference: MFOptimizationConfiguration)."""

    random_effect_type: str
    feature_shard: str
    latent_dim: int
    num_inner_iterations: int = 1
    optimization: GLMOptimizationConfig = GLMOptimizationConfig()
    latent_optimization: GLMOptimizationConfig = GLMOptimizationConfig()
    active_data_upper_bound: Optional[int] = None
    passive_data_lower_bound: Optional[int] = None
    # per-coordinate inexact-solve schedule (both the latent-space and the
    # projection solves); None = inherit the training config's
    solver_schedule: Optional[SolverSchedule] = None

    def __post_init__(self):
        if self.latent_dim < 1:
            raise ValueError("latent_dim must be >= 1")
        if self.num_inner_iterations < 1:
            raise ValueError("num_inner_iterations must be >= 1")

    def data_config(self, seed: int = 7,
                    keep_host_blocks: bool = False) -> RandomEffectDataConfig:
        # features stay in the shard's space ("identity"): the latent
        # projection is part of the model and is refit every update
        return RandomEffectDataConfig(
            random_effect_type=self.random_effect_type,
            feature_shard=self.feature_shard,
            active_data_upper_bound=self.active_data_upper_bound,
            passive_data_lower_bound=self.passive_data_lower_bound,
            projector="identity",
            seed=seed, keep_host_blocks=keep_host_blocks)


CoordinateConfig = Union[FixedEffectCoordinateConfig, RandomEffectCoordinateConfig,
                         FactoredRandomEffectCoordinateConfig]


@dataclasses.dataclass(frozen=True)
class GameTrainingConfig:
    """Task, per-coordinate configs, updating sequence, outer iterations."""

    task_type: str
    coordinates: Dict[str, CoordinateConfig]
    updating_sequence: Sequence[str]
    num_outer_iterations: int = 1
    seed: int = 7
    hbm_budget_bytes: Optional[int] = None
    # inexact coordinate descent (optim/schedule.py): small iteration caps
    # and loose tolerances on early outer iterations, the full budget on
    # the final one; a coordinate's own solver_schedule overrides it.
    # None = full solves every visit
    solver_schedule: Optional[SolverSchedule] = None

    def __post_init__(self):
        missing = [c for c in self.updating_sequence if c not in self.coordinates]
        if missing:
            raise ValueError(f"updating_sequence names unknown coordinates: {missing}")
        if self.num_outer_iterations < 1:
            raise ValueError("num_outer_iterations must be >= 1")
        if self.hbm_budget_bytes is not None and self.hbm_budget_bytes <= 0:
            raise ValueError("hbm_budget_bytes must be positive (use None "
                             "for unbounded)")

    # -- JSON round-trip ------------------------------------------------------
    def to_dict(self) -> dict:
        def enc_opt(o: OptimizerConfig):
            return {"optimizer": o.optimizer.value, "max_iterations": o.max_iterations,
                    "tolerance": o.tolerance, "history": o.history,
                    "max_cg_iterations": o.max_cg_iterations,
                    "box_lower": list(o.box_lower) if o.box_lower else None,
                    "box_upper": list(o.box_upper) if o.box_upper else None,
                    # the reference's JSON shape (GLMSuite constraint string)
                    "constraints": (constraints_to_json(o.constraints)
                                    if o.constraints else None),
                    "track_coefficients": o.track_coefficients}

        def enc_glm(g: GLMOptimizationConfig):
            out = {"optimizer": enc_opt(g.optimizer),
                   "regularization": {"type": g.regularization.reg_type.value,
                                      "alpha": g.regularization.elastic_net_alpha},
                   "regularization_weight": g.regularization_weight,
                   "downsampling_rate": g.downsampling_rate}
            # only when set, so configs without the lane keep their
            # fingerprints
            if g.admm is not None:
                a = g.admm
                out["admm"] = {"max_iterations": a.max_iterations,
                               "tolerance": a.tolerance, "rho": a.rho,
                               "adapt_rho": a.adapt_rho,
                               "rho_tau": a.rho_tau, "rho_mu": a.rho_mu,
                               "newton_steps": a.newton_steps,
                               "polish": a.polish}
            return out

        # None (no schedule) encodes as None, which checkpoint fingerprints
        # strip
        def enc_sched(s):
            return None if s is None else s.to_dict()

        coords = {}
        for name, c in self.coordinates.items():
            if isinstance(c, FixedEffectCoordinateConfig):
                coords[name] = {"kind": "fixed_effect",
                                "feature_shard": c.feature_shard,
                                "normalization": c.normalization.value,
                                "shard_features": c.shard_features,
                                # "auto" (the default) encodes as absent
                                "memory_mode": (None if c.memory_mode == "auto"
                                                else c.memory_mode),
                                "chunk_rows": c.chunk_rows,
                                "solver_schedule": enc_sched(c.solver_schedule),
                                "optimization": enc_glm(c.optimization)}
            elif isinstance(c, FactoredRandomEffectCoordinateConfig):
                coords[name] = {"kind": "factored_random_effect",
                                "random_effect_type": c.random_effect_type,
                                "feature_shard": c.feature_shard,
                                "latent_dim": c.latent_dim,
                                "num_inner_iterations": c.num_inner_iterations,
                                "active_data_upper_bound": c.active_data_upper_bound,
                                "passive_data_lower_bound": c.passive_data_lower_bound,
                                "solver_schedule": enc_sched(c.solver_schedule),
                                "optimization": enc_glm(c.optimization),
                                "latent_optimization": enc_glm(c.latent_optimization)}
            else:
                coords[name] = {"kind": "random_effect",
                                "random_effect_type": c.random_effect_type,
                                "feature_shard": c.feature_shard,
                                "active_data_upper_bound": c.active_data_upper_bound,
                                "passive_data_lower_bound": c.passive_data_lower_bound,
                                "features_to_samples_ratio": c.features_to_samples_ratio,
                                "projector": c.projector,
                                "solver_schedule": enc_sched(c.solver_schedule),
                                "optimization": enc_glm(c.optimization)}
        return {"task_type": self.task_type, "coordinates": coords,
                "updating_sequence": list(self.updating_sequence),
                "num_outer_iterations": self.num_outer_iterations,
                "seed": self.seed,
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "solver_schedule": enc_sched(self.solver_schedule)}

    @staticmethod
    def from_dict(d: dict) -> "GameTrainingConfig":
        def dec_opt(o: dict) -> OptimizerConfig:
            return OptimizerConfig(
                optimizer=OptimizerType(o["optimizer"]),
                max_iterations=o.get("max_iterations"),
                tolerance=o.get("tolerance"),
                history=o.get("history", 10),
                max_cg_iterations=o.get("max_cg_iterations", 20),
                box_lower=tuple(o["box_lower"]) if o.get("box_lower") else None,
                box_upper=tuple(o["box_upper"]) if o.get("box_upper") else None,
                constraints=(tuple(o["constraints"])
                             if o.get("constraints") else None),
                track_coefficients=o.get("track_coefficients", False))

        def dec_glm(g: dict) -> GLMOptimizationConfig:
            admm = None
            if g.get("admm") is not None:
                a = g["admm"]
                admm = ADMMConfig(
                    max_iterations=a.get("max_iterations"),
                    tolerance=a.get("tolerance"),
                    rho=a.get("rho", 1.0),
                    adapt_rho=a.get("adapt_rho", True),
                    rho_tau=a.get("rho_tau", 2.0),
                    rho_mu=a.get("rho_mu", 10.0),
                    newton_steps=a.get("newton_steps", 8),
                    polish=a.get("polish", True))
            return GLMOptimizationConfig(
                optimizer=dec_opt(g["optimizer"]),
                regularization=RegularizationContext(
                    RegularizationType(g["regularization"]["type"]),
                    g["regularization"].get("alpha")),
                regularization_weight=g["regularization_weight"],
                downsampling_rate=g.get("downsampling_rate"),
                admm=admm)

        coords: Dict[str, CoordinateConfig] = {}
        for name, c in d["coordinates"].items():
            sched = SolverSchedule.from_dict(c.get("solver_schedule"))
            if c["kind"] == "fixed_effect":
                coords[name] = FixedEffectCoordinateConfig(
                    feature_shard=c["feature_shard"],
                    optimization=dec_glm(c["optimization"]),
                    normalization=NormalizationType(c.get("normalization", "none")),
                    shard_features=c.get("shard_features"),
                    memory_mode=c.get("memory_mode") or "auto",
                    chunk_rows=c.get("chunk_rows"),
                    solver_schedule=sched)
            elif c["kind"] == "factored_random_effect":
                coords[name] = FactoredRandomEffectCoordinateConfig(
                    random_effect_type=c["random_effect_type"],
                    feature_shard=c["feature_shard"],
                    latent_dim=c["latent_dim"],
                    num_inner_iterations=c.get("num_inner_iterations", 1),
                    optimization=dec_glm(c["optimization"]),
                    latent_optimization=dec_glm(c["latent_optimization"]),
                    active_data_upper_bound=c.get("active_data_upper_bound"),
                    passive_data_lower_bound=c.get("passive_data_lower_bound"),
                    solver_schedule=sched)
            else:
                coords[name] = RandomEffectCoordinateConfig(
                    random_effect_type=c["random_effect_type"],
                    feature_shard=c["feature_shard"],
                    optimization=dec_glm(c["optimization"]),
                    active_data_upper_bound=c.get("active_data_upper_bound"),
                    passive_data_lower_bound=c.get("passive_data_lower_bound"),
                    features_to_samples_ratio=c.get("features_to_samples_ratio"),
                    projector=c.get("projector", "index_map"),
                    solver_schedule=sched)
        return GameTrainingConfig(
            task_type=d["task_type"], coordinates=coords,
            updating_sequence=d["updating_sequence"],
            num_outer_iterations=d.get("num_outer_iterations", 1),
            seed=d.get("seed", 7),
            hbm_budget_bytes=d.get("hbm_budget_bytes"),
            solver_schedule=SolverSchedule.from_dict(d.get("solver_schedule")))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_json(s: str) -> "GameTrainingConfig":
        return GameTrainingConfig.from_dict(json.loads(s))
