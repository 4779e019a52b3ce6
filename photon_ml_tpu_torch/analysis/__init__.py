"""photonlint for the port: static analysis of the hot-path invariants.

A copy of the JAX package's linter (its engine, rule catalog, concurrency
pass and CLI) with the package name a parameter and torch semantics for the
rules whose JAX meaning was a JAX call: zero builds or captures when warm,
a designed read-back per iteration and no host sync elsewhere on the hot
path, no read of a buffer after its hand-off, fsync+atomic-replace writes,
string-literal fault sites, and a lock-order graph the runtime tracker
(`utils/locktrace.py`) is held to.

    python -m photon_ml_tpu_torch.analysis.lint photon_ml_tpu_torch/

Rules (`--list-rules` prints the catalog; README "The port's linter"):

  PH001  torch host syncs in hot-path modules (.item()/.tolist()/.cpu()/
         .numpy()/.to("cpu"), float()/int()/bool()/np.asarray/range() on a
         device value, torch.cuda.synchronize(), stream/event
         .synchronize()) outside flush points
  PH002  a build or graph capture at call time (torch.compile, torch.jit.*,
         CUDA-graph capture, _build.load_library with a non-literal name)
  PH003  a read after a hand-off (an alias of an `out=` buffer, a chunk of
         a Prefetcher `.stream()` loop after the loop moved on)
  PH004  fault-site discipline (string-literal sites declared in
         utils.faults.SITES, declared context keys only)
  PH005  durability (checkpoint/model-io writes go through
         utils.durable helpers, never bare open(..., "w")/json.dump)
  PH006  time.*/random.* inside a graph capture
  PH007  raw span timing in hot-path modules
  PH008  telemetry event-registry drift
  PH010–PH013  the concurrency pass (guarded attributes, lock order,
         blocking under a lock, check-then-act)
  PH014  multi-writer discipline in multi-process modules

Suppression: `# photonlint: disable=PH001` on the finding's line,
`# photonlint: disable-file=PH001` anywhere in a file,
`# photonlint: flush-point` on a `def` line to whitelist a designated
host-sync flush point (PH001).  Grandfathered findings live in
`analysis/baseline.json` (`--write-baseline` regenerates it; PH001 only).
"""
from photon_ml_tpu_torch.analysis.engine import Finding, lint_paths  # noqa: F401
