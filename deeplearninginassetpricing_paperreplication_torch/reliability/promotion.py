"""Checkpoint promotion control plane: the gated path from "a candidate
finished training" to "the fleet serves it".

The port's copy of the JAX package's ``reliability/promotion.py``. A
**candidate** (K member run dirs) is promoted only after it passes the
gate, in the JAX order:

  1. **digest verification** — every member's ``config.json`` parses and
     its ``.pt``'s bytes match the ``.sha256`` sidecar
     (:mod:`reliability.verified`; the port writes one beside every
     checkpoint). A torn candidate is rejected here (``digest_mismatch``),
     before any deserialization; candidates never fall back a generation.
  2. **stacking** (``stack_error``) and **architecture compatibility**
     (``architecture_mismatch``) — the candidate's config hash must equal
     the serving config's.
  3. **model health** (``moment_violation``, opt-in) — the worst member's
     per-moment conditional violation norm on the validation batch, from
     one S-member diagnostics call (``observability.modelhealth``); before
     the finite check, so a degenerate candidate is named by the moment
     conditions it breaks.
  4. **data drift** (``data_drift``, opt-in) — the validation panel's PSI
     against the candidate's ``reference_profile.json``.
  5. **paper-protocol validation** — finite params (``nonfinite_params``),
     finite served weights and SDF (``nonfinite_outputs``) and a validation
     Sharpe within a tolerance of the incumbent's (``sharpe_regression``),
     through the port's ``ensemble_metrics``.

On pass the **promotion pointer** — ``serving_current.json`` under the
control-plane root — atomically advances (tmp + ``os.replace`` + sha256
sidecar + ``.g1`` rotation) to the candidate, with the previous head kept in
an embedded ``history`` list. A kill at any point (the ``promote/validate``
and ``promote/write`` fault sites, or inside the verified write) leaves the
old or the new pointer, never a torn one. :func:`rollback` reverts the
pointer to the previous history entry the same way. The pointer records
each member's artifact digest (:func:`verify_pointer_members`).

The pointer has the JAX package's schema, but its ``params_fingerprint`` is
the port's ``serving.engine.params_digest`` (over the ``state_dict``
tensors), not the JAX one (over the flax tree): a pointer is readable by
both packages, but not to be shared between them.

The validation pass runs on the CUDA device unless the caller asks for the
CPU (``exec_cfg`` / ``--device cpu``). Given an ``EventLog``
(``events=``), :func:`promote` and :func:`rollback` count the gate's
decisions with the JAX package's names and attributes:
``promote/reject`` (reason, source), ``promote/advance`` (generation,
source, fingerprint, sharpe) and ``promote/rollback`` (generation,
rolled_back_from, fingerprint, reason). Module level stays stdlib-only:
thin readers load pointers without importing torch.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .faults import inject
from .verified import check_digest, load_verified, verified_exists, write_verified

POINTER_FILENAME = "serving_current.json"
DEFAULT_SHARPE_TOLERANCE = 0.05
DEFAULT_HISTORY_KEEP = 8

# the pointer-head fields a history entry retains (history entries never
# nest their own history)
_HEAD_KEYS = (
    "generation", "checkpoint_dirs", "config_hash", "params_fingerprint",
    "valid_sharpe", "moment_violation_max", "drift_max_psi", "source",
    "promoted_at", "members", "rolled_back_from",
)


class PromotionError(RuntimeError):
    """The control plane itself is unusable (no pointer to roll back to,
    malformed root, ...) — distinct from a candidate failing the gate."""


class GateRejection(PromotionError):
    """The candidate failed the gate; ``reason`` is a stable slug the
    report CLI buckets rejections by."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"candidate rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason
        self.detail = detail


def pointer_path(root: Union[str, Path]) -> Path:
    """``root`` is the control-plane directory (or the pointer file
    itself, for callers holding a direct path)."""
    root = Path(root)
    return root if root.name.endswith(".json") else root / POINTER_FILENAME


def read_pointer(root: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """The current promotion pointer, digest-verified, falling back a
    generation past a torn newest write (``reliability.verified``); None
    when no pointer exists yet. Raises ``ValueError`` when every
    generation is unusable — serving must not guess."""
    path = pointer_path(root)
    if not verified_exists(path):
        return None

    def parse(data: bytes) -> Dict[str, Any]:
        try:
            obj = json.loads(data.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"corrupt promotion pointer {path}: {e}") from e
        if not isinstance(obj, dict) or "checkpoint_dirs" not in obj:
            raise ValueError(
                f"promotion pointer {path} carries no checkpoint_dirs")
        return obj

    pointer, _ = load_verified(path, parse)
    return pointer


def write_pointer(
    root: Union[str, Path],
    head: Dict[str, Any],
    history_keep: int = DEFAULT_HISTORY_KEEP,
) -> Dict[str, Any]:
    """Advance the pointer to ``head`` atomically, stamping the next
    generation number and folding the previous head into ``history``
    (newest first, bounded). The ``promote/write`` fault site fires with
    the previous pointer still intact; the write itself is a
    ``reliability.verified`` tmp+replace, so a kill anywhere leaves either
    the old or the new pointer — never a torn one."""
    path = pointer_path(root)
    prev = read_pointer(root)
    pointer = dict(head)
    pointer["kind"] = "serving_pointer"
    pointer["generation"] = (int(prev["generation"]) + 1) if prev else 1
    history: List[Dict[str, Any]] = []
    if prev is not None:
        history.append({k: prev[k] for k in _HEAD_KEYS if k in prev})
        history.extend(prev.get("history") or [])
    pointer["history"] = history[:history_keep]
    inject("promote/write", path=str(path), generation=pointer["generation"])
    write_verified(path, json.dumps(pointer, indent=2).encode())
    return pointer


# -- candidate verification ---------------------------------------------------


def member_artifact_path(member_dir: Union[str, Path],
                         which: str = "best_model_sharpe") -> Path:
    return Path(member_dir) / f"{which}.pt"


def verify_member_dirs(
    checkpoint_dirs: Sequence[Union[str, Path]],
    which: str = "best_model_sharpe",
) -> Tuple[List[Dict[str, Any]], Optional[Tuple[str, str]]]:
    """Stdlib-only gate stage 1: every member's config parses and its
    params artifact digest-verifies (CURRENT generation only — a torn
    candidate is a rejection, not a fallback). Returns
    ``(members, rejection)`` where members carry each artifact's exact
    sha256 (recorded into the pointer for reload-time verification) and
    rejection is ``(reason, detail)`` or None."""
    members: List[Dict[str, Any]] = []
    for d in checkpoint_dirs:
        d = Path(d)
        cfg_path = d / "config.json"
        try:
            json.loads(cfg_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            return members, ("config_unreadable", f"{cfg_path}: {e}")
        art = member_artifact_path(d, which)
        if not art.exists():
            return members, ("missing_member", f"{art} does not exist")
        data = art.read_bytes()
        digest = hashlib.sha256(data).hexdigest()
        ok, why = check_digest(art, data, digest=digest)
        if not ok:
            return members, ("digest_mismatch", f"{art}: {why}")
        members.append({
            "dir": str(d),
            "file": art.name,
            "sha256": digest,
            "bytes": len(data),
        })
    return members, None


def verify_pointer_members(pointer: Dict[str, Any]) -> List[str]:
    """Reload-time check: do the on-disk member artifacts still hold the
    exact bytes the gate validated? Returns a list of mismatch
    descriptions (empty = verified): a reader of the pointer that finds a
    member torn AFTER promotion refuses the whole candidate instead of
    loading a mixed ensemble."""
    errors: List[str] = []
    for m in pointer.get("members") or []:
        path = Path(m["dir"]) / m["file"]
        try:
            data = path.read_bytes()
        except OSError as e:
            errors.append(f"{path}: unreadable ({e})")
            continue
        got = hashlib.sha256(data).hexdigest()
        if got != m["sha256"]:
            errors.append(
                f"{path}: sha256 {got[:12]}… != promoted {m['sha256'][:12]}…")
    return errors


def evaluate_candidate(
    checkpoint_dirs: Sequence[str],
    valid_batch: Optional[Dict[str, Any]] = None,
    which: str = "best_model_sharpe",
    with_moments: bool = False,
    exec_cfg=None,
) -> Dict[str, Any]:
    """Gate stage 2 (torch, imported lazily): stack the candidate ensemble
    on ``exec_cfg.device`` (the card unless the caller asks for the CPU),
    check every parameter is finite, and, given a validation batch, run the
    paper-protocol ensemble reduction (``parallel.ensemble.ensemble_metrics``)
    to check the served weights and SDF are finite and measure the
    validation Sharpe.

    ``with_moments``: also the model-health diagnostics
    (``observability.modelhealth.candidate_diagnostics``: one S-member
    call, worst case over members), whose per-moment violation norms the
    ``moment_violation`` gate thresholds. Computed for non-finite params
    too (the violations are then non-finite, the evidence the gate
    needs).

    A member set that does not stack raises :class:`GateRejection`
    (``stack_error``); an error of the diagnostics or the ensemble pass (a
    kernel that fails to launch) propagates as it is."""
    import numpy as np
    import torch

    from ..evaluate_ensemble import stack_checkpoints
    from ..parallel.ensemble import ensemble_metrics
    from ..observability.manifest import config_hash
    from ..serving.engine import params_digest
    from ..utils.config import ExecutionConfig, resolve_device

    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    try:
        cfg, stacked = stack_checkpoints([str(d) for d in checkpoint_dirs],
                                         which, device=device)
    except (ValueError, FileNotFoundError) as e:
        # architecture mismatch AMONG members, or an artifact whose every
        # generation is unusable — stack_checkpoints says which
        raise GateRejection("stack_error", str(e)) from e
    finite_params = all(bool(torch.isfinite(v).all())
                        for v in stacked.values())
    out: Dict[str, Any] = {
        "config_hash": config_hash(cfg),
        "params_fingerprint": params_digest(stacked),
        "finite_params": finite_params,
        "finite_outputs": None,
        "valid_sharpe": None,
        "moment_violation_max": None,
        "moment_violations": None,
        "sdf_finite_frac": None,
    }
    batch = None
    if valid_batch is not None:
        # n_assets rides along: a stock-padded validation panel must not
        # dilute the violation norms the tolerance gates
        batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                    device=device)
                 for k, v in valid_batch.items()
                 if k in ("macro", "individual", "returns", "mask",
                          "n_assets")}
    if batch is not None and with_moments:
        from ..models.gan import GAN
        from ..observability.modelhealth import candidate_diagnostics

        diag = candidate_diagnostics(GAN(cfg, exec_cfg), stacked, batch)
        out["moment_violation_max"] = diag["moment_violation_max"]
        out["moment_violations"] = diag["moment_violations"]
        out["sdf_finite_frac"] = diag["sdf_finite_frac"]
    if batch is not None and finite_params:
        metrics = ensemble_metrics(cfg, stacked, batch, exec_cfg)
        weights = np.asarray(metrics["avg_weights"])
        port = np.asarray(metrics["ensemble_port_returns"])
        sharpe = float(metrics["ensemble_sharpe"])
        out["finite_outputs"] = bool(
            np.isfinite(weights).all() and np.isfinite(port).all()
            and np.isfinite(sharpe))
        out["valid_sharpe"] = sharpe if out["finite_outputs"] else None
    return out


# -- the gate -----------------------------------------------------------------


def _counter(events, name: str, **attrs: Any) -> None:
    if events is not None:
        events.counter(name, **attrs)


def candidate_reference_profile(
    checkpoint_dirs: Sequence[str],
    reference_profile: Optional[Union[str, Path, Dict[str, Any]]] = None,
) -> Optional[Dict[str, Any]]:
    """Resolve the reference profile the drift gate scores against: an
    explicit dict/path wins; otherwise the first member dir carrying a
    ``reference_profile.json`` (written by the train CLI — the
    fingerprint of the data the candidate learned from)."""
    from ..observability.drift import read_profile

    if isinstance(reference_profile, dict):
        return reference_profile
    if reference_profile is not None:
        return read_profile(reference_profile)
    for d in checkpoint_dirs:
        profile = read_profile(d)
        if profile is not None:
            return profile
    return None


def promote(
    root: Union[str, Path],
    checkpoint_dirs: Sequence[str],
    valid_batch: Optional[Dict[str, Any]] = None,
    source: Optional[str] = None,
    expect_config_hash: Optional[str] = None,
    sharpe_tolerance: Optional[float] = DEFAULT_SHARPE_TOLERANCE,
    which: str = "best_model_sharpe",
    history_keep: int = DEFAULT_HISTORY_KEEP,
    moment_tolerance: Optional[float] = None,
    drift_threshold: Optional[float] = None,
    reference_profile: Optional[Union[str, Path, Dict[str, Any]]] = None,
    exec_cfg=None,
    events=None,
) -> Dict[str, Any]:
    """Run the candidate through the gate; on pass, atomically advance the
    promotion pointer and return it. Raises :class:`GateRejection` (with a
    stable ``reason``) on any gate failure — the pointer is then untouched
    and the fleet keeps serving the incumbent.

    ``expect_config_hash`` pins the serving architecture explicitly; when
    None, the incumbent pointer's hash is the contract (a first promotion
    with neither accepts any self-consistent architecture).
    ``sharpe_tolerance=None`` disables the regression gate (the Sharpe is
    still measured and recorded when a validation batch is given).

    Model-health gates (both opt-in; require a validation batch):

    * ``moment_tolerance`` — reject with reason ``moment_violation`` when
      the candidate's worst per-moment conditional violation norm
      (``E[h_j · w·R · M]``, worst case over the members) is non-finite or
      exceeds the tolerance. Runs BEFORE the finite-params check, so a
      degenerate candidate is attributed to the moment conditions it
      breaks, not just to its NaN leaves.
    * ``drift_threshold`` — reject with reason ``data_drift`` when the
      validation panel's PSI against the candidate's reference profile
      (``reference_profile.json`` written by the train CLI, or the
      explicit ``reference_profile``) exceeds the threshold: the candidate
      learned from data that no longer looks like what it will serve.
      Skipped (recorded as None) when no profile is resolvable.

    ``exec_cfg``: the validation pass's ``ExecutionConfig`` (device,
    kernel route, compute dtype); the default runs on the card.
    ``events``: an ``EventLog`` that counts ``promote/reject`` and
    ``promote/advance``."""
    # the ONE finite-float coercion shared with the health plane
    from ..observability.modelhealth import _finite_or_none as _finite

    dirs = [str(d) for d in checkpoint_dirs]
    src = source or ";".join(Path(d).name for d in dirs)
    inject("promote/validate", path=src, n_members=len(dirs))

    def reject(reason: str, detail: str = "") -> None:
        _counter(events, "promote/reject", reason=reason, source=src)
        raise GateRejection(reason, detail)

    if not dirs:
        reject("missing_member", "no candidate checkpoint dirs")
    incumbent = read_pointer(root)
    members, rejection = verify_member_dirs(dirs, which)
    if rejection is not None:
        reject(*rejection)
    evaluation = evaluate_candidate(
        dirs, valid_batch, which,
        with_moments=moment_tolerance is not None, exec_cfg=exec_cfg)
    expected = expect_config_hash or (
        incumbent.get("config_hash") if incumbent else None)
    if expected and evaluation["config_hash"] != expected:
        reject("architecture_mismatch",
               f"candidate config {evaluation['config_hash'][:12]}… != "
               f"serving {expected[:12]}…")
    if moment_tolerance is not None and valid_batch is not None:
        # THE threshold decision lives in modelhealth.HealthThresholds
        # (shared with the report tooling); this block only composes the
        # rejection detail
        from ..observability.modelhealth import HealthThresholds

        thresholds = HealthThresholds(
            moment_tolerance=float(moment_tolerance))
        if "moment_violation" in thresholds.classify(evaluation):
            mv = _finite(evaluation.get("moment_violation_max"))
            frac = _finite(evaluation.get("sdf_finite_frac"))
            if mv is None or frac is None or frac < 1.0:
                reject("moment_violation",
                       "candidate per-moment violations / SDF series are "
                       "non-finite on the validation batch")
            reject("moment_violation",
                   f"max per-moment conditional violation {mv:.6f} > "
                   f"tolerance {float(moment_tolerance):.6f}")
    drift_max_psi = None
    if drift_threshold is not None and valid_batch is not None:
        profile = candidate_reference_profile(dirs, reference_profile)
        if profile is not None:
            from ..observability.drift import drift_report

            report = drift_report(profile, valid_batch)
            drift_max_psi = report["max_psi"]
            if drift_max_psi is not None \
                    and drift_max_psi > float(drift_threshold):
                worst = max(
                    (d["psi"], name)
                    for name, d in report["per_series"].items()
                    if d["psi"] is not None)
                reject("data_drift",
                       f"max PSI {drift_max_psi:.4f} > threshold "
                       f"{float(drift_threshold):.4f} (worst series "
                       f"{worst[1]}; panel has drifted from the "
                       "candidate's training data)")
    if not evaluation["finite_params"]:
        reject("nonfinite_params",
               "candidate params contain NaN/Inf leaves")
    if evaluation["finite_outputs"] is False:
        reject("nonfinite_outputs",
               "candidate weights/SDF non-finite on the validation batch")
    if (sharpe_tolerance is not None and incumbent is not None
            and incumbent.get("valid_sharpe") is not None
            and evaluation["valid_sharpe"] is not None
            and evaluation["valid_sharpe"]
            < float(incumbent["valid_sharpe"]) - float(sharpe_tolerance)):
        reject("sharpe_regression",
               f"candidate valid Sharpe {evaluation['valid_sharpe']:.4f} < "
               f"incumbent {float(incumbent['valid_sharpe']):.4f} - "
               f"tolerance {float(sharpe_tolerance):.4f}")

    pointer = write_pointer(root, {
        "checkpoint_dirs": dirs,
        "config_hash": evaluation["config_hash"],
        "params_fingerprint": evaluation["params_fingerprint"],
        "valid_sharpe": evaluation["valid_sharpe"],
        "moment_violation_max": _finite(
            evaluation.get("moment_violation_max")),
        "drift_max_psi": drift_max_psi,
        "source": src,
        "promoted_at": round(time.time(), 3),
        "members": members,
    }, history_keep=history_keep)
    _counter(events, "promote/advance", generation=pointer["generation"],
             source=src, fingerprint=pointer["params_fingerprint"][:16],
             sharpe=pointer["valid_sharpe"])
    return pointer


def rollback(
    root: Union[str, Path],
    reason: str = "",
    history_keep: int = DEFAULT_HISTORY_KEEP,
    events=None,
) -> Dict[str, Any]:
    """Revert the pointer to the previous history entry (same atomic
    write; the bad head joins the history with ``rolled_back_from`` set so
    the audit trail survives). Raises :class:`PromotionError` when there
    is nothing to roll back to. ``events``: an ``EventLog`` that counts
    ``promote/rollback``."""
    current = read_pointer(root)
    if current is None:
        raise PromotionError(f"no promotion pointer under {root}")
    history = current.get("history") or []
    if not history:
        raise PromotionError(
            f"pointer generation {current.get('generation')} has no "
            "previous generation to roll back to")
    prev = history[0]
    head = {k: prev[k] for k in _HEAD_KEYS
            if k in prev and k not in ("generation", "rolled_back_from")}
    head["rolled_back_from"] = current.get("generation")
    head["rollback_reason"] = reason
    pointer = write_pointer(root, head, history_keep=history_keep)
    _counter(events, "promote/rollback",
             generation=pointer["generation"],
             rolled_back_from=current.get("generation"),
             fingerprint=str(pointer.get("params_fingerprint"))[:16],
             reason=reason)
    return pointer


# -- CLI ----------------------------------------------------------------------


def _load_valid_npz(path: str) -> Dict[str, Any]:
    import numpy as np

    with np.load(path, allow_pickle=False) as f:
        return {k: np.asarray(f[k]) for k in f.files}


def main(argv=None) -> int:
    import argparse

    from ..evaluate_ensemble import add_execution_args, execution_config

    p = argparse.ArgumentParser(
        prog="python -m deeplearninginassetpricing_paperreplication_torch"
             ".reliability.promotion",
        description="Gate a candidate checkpoint ensemble into the "
                    "promotion pointer (promote), revert it (rollback), "
                    "or print it (show)")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("promote")
    pr.add_argument("--root", required=True,
                    help="control-plane dir holding serving_current.json")
    pr.add_argument("--candidates", nargs="+", required=True,
                    help="member checkpoint run dirs")
    pr.add_argument("--valid_npz", default=None,
                    help=".npz with individual/returns/mask (+macro) arrays "
                         "— the validation batch for the finite-SDF and "
                         "Sharpe checks")
    pr.add_argument("--source", default=None)
    pr.add_argument("--expect_config_hash", default=None)
    pr.add_argument("--sharpe_tolerance", type=float,
                    default=DEFAULT_SHARPE_TOLERANCE,
                    help="negative disables the regression gate")
    pr.add_argument("--moment_tolerance", type=float, default=None,
                    help="model-health gate: reject (reason "
                         "moment_violation) when the candidate's worst "
                         "per-moment conditional violation norm exceeds "
                         "this, or is non-finite (requires --valid_npz)")
    pr.add_argument("--drift_threshold", type=float, default=None,
                    help="data-drift gate: reject (reason data_drift) "
                         "when the validation panel's max PSI against the "
                         "candidate's reference_profile.json exceeds this "
                         "(0.25 is the standard significant-shift bar; "
                         "requires --valid_npz)")
    pr.add_argument("--reference_profile", type=str, default=None,
                    help="explicit reference_profile.json path for the "
                         "drift gate (default: the first member dir "
                         "carrying one)")
    add_execution_args(pr)
    rb = sub.add_parser("rollback")
    rb.add_argument("--root", required=True)
    rb.add_argument("--reason", default="")
    sh = sub.add_parser("show")
    sh.add_argument("--root", required=True)
    args = p.parse_args(argv)

    if args.cmd == "show":
        pointer = read_pointer(args.root)
        print(json.dumps(pointer, indent=2))
        return 0 if pointer is not None else 1
    if args.cmd == "rollback":
        pointer = rollback(args.root, reason=args.reason)
        print(json.dumps({"generation": pointer["generation"],
                          "rolled_back_from": pointer.get(
                              "rolled_back_from")}))
        return 0
    exec_cfg = execution_config(args)  # exits naming CUDA without a card
    valid_batch = (_load_valid_npz(args.valid_npz)
                   if args.valid_npz else None)
    tol = (None if args.sharpe_tolerance is not None
           and args.sharpe_tolerance < 0 else args.sharpe_tolerance)
    try:
        pointer = promote(
            args.root, args.candidates, valid_batch=valid_batch,
            source=args.source, expect_config_hash=args.expect_config_hash,
            sharpe_tolerance=tol,
            moment_tolerance=args.moment_tolerance,
            drift_threshold=args.drift_threshold,
            reference_profile=args.reference_profile, exec_cfg=exec_cfg)
    except GateRejection as e:
        print(json.dumps({"rejected": e.reason, "detail": e.detail}))
        return 1
    print(json.dumps({"generation": pointer["generation"],
                      "params_fingerprint":
                          pointer["params_fingerprint"][:16],
                      "valid_sharpe": pointer["valid_sharpe"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
