"""Runtime (string-driven) component selection (counterpart of
``amgcl_tpu/models/runtime.py``).

The reference's L8: every policy is selectable by name with parameters
flowing through a property tree with dotted paths
(``precond.coarsening.type=smoothed_aggregation``, ``solver.tol=1e-8``) —
amgcl/solver/runtime.hpp:60-120, amgcl/preconditioner/runtime.hpp:54-119,
amgcl/util.hpp:103-183 (param import/export, unknown-key warnings).

The property tree is a plain dict (nested or dotted) or a JSON file path;
components are dataclasses, and unknown keys warn as ``check_params``
does. Every entry point takes ``device`` (None: CUDA) and passes it to
what it builds.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Dict

import numpy as np
import torch

from amgcl_tpu_torch.coarsening import (Aggregation, AsScalar, RugeStuben,
                                        SmoothedAggrEMin,
                                        SmoothedAggregation)
from amgcl_tpu_torch.models.amg import AMG, AMGParams, check_dtype
from amgcl_tpu_torch.models.make_solver import make_solver
from amgcl_tpu_torch.models.preconditioner import (AsPreconditioner,
                                                   DummyPreconditioner,
                                                   NestedPreconditioner)
from amgcl_tpu_torch.relaxation import (ILU0, ILUK, ILUP, ILUT, AsBlock,
                                        Chebyshev, DampedJacobi, GaussSeidel,
                                        Spai0, Spai1)
from amgcl_tpu_torch.serve.batched import BlockCG
from amgcl_tpu_torch.solver import (CG, FGMRES, GMRES, IDRs, LGMRES,
                                    BiCGStab, BiCGStabL, PreOnly, Richardson)

#: solver names (``blockcg``: the serving layer's block CG)
SOLVERS = {
    "cg": CG, "bicgstab": BiCGStab, "bicgstabl": BiCGStabL,
    "gmres": GMRES, "fgmres": FGMRES, "lgmres": LGMRES, "idrs": IDRs,
    "richardson": Richardson, "preonly": PreOnly, "blockcg": BlockCG,
}

RELAXATION = {
    "damped_jacobi": DampedJacobi, "spai0": Spai0, "spai1": Spai1,
    "chebyshev": Chebyshev, "gauss_seidel": GaussSeidel, "ilu0": ILU0,
    "ilup": ILUP, "iluk": ILUK, "ilut": ILUT, "as_block": AsBlock,
}

COARSENING = {
    "smoothed_aggregation": SmoothedAggregation, "aggregation": Aggregation,
    "ruge_stuben": RugeStuben, "as_scalar": AsScalar,
    "smoothed_aggr_emin": SmoothedAggrEMin,
}


class _Dtypes(dict):
    """Dtype names; looking up one the port has no kernels for raises
    NotImplementedError naming its ROADMAP item (``check_dtype``)."""

    def __getitem__(self, name):
        return check_dtype(dict.__getitem__(self, name))


DTYPES = _Dtypes({
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "complex64": torch.complex64,
    "complex128": torch.complex128,
})


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted keys -> nested dict (`a.b.c: v` -> {a: {b: {c: v}}})."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
            if not isinstance(d, dict):
                raise ValueError("conflicting keys at %r" % k)
        if isinstance(v, dict):
            v = _nest(v)
            if isinstance(d.get(parts[-1]), dict):
                d[parts[-1]].update(v)
            else:
                d[parts[-1]] = v
        else:
            d[parts[-1]] = v
    return out


def _build_dataclass(cls, prm: Dict[str, Any], path: str):
    """Instantiate a dataclass from string-ish params, warning on unknown
    keys (the check_params behaviour, amgcl/util.hpp:148-183)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in prm.items():
        if k == "type":
            continue
        if k not in fields:
            warnings.warn("unknown parameter %s.%s" % (path, k))
            continue
        ftype = str(fields[k].type)
        if isinstance(v, str):
            if "int" in ftype:
                v = int(v)
            elif "float" in ftype:
                v = float(v)
            elif "bool" in ftype:
                v = v.lower() in ("1", "true", "yes")
        kwargs[k] = v
    return cls(**kwargs)


def _as_dict(prm) -> Dict[str, Any]:
    if prm is None:
        return {}
    if isinstance(prm, str):
        with open(prm) as f:
            prm = json.load(f)
    return _nest(dict(prm))


def solver_from_params(prm: Dict[str, Any]):
    """``{"type": "cg", "tol": 1e-8, ...}`` -> solver instance."""
    kind = str(prm.get("type", "bicgstab"))
    if kind not in SOLVERS:
        raise ValueError("unknown solver %r (have: %s)"
                         % (kind, sorted(SOLVERS)))
    return _build_dataclass(SOLVERS[kind], prm, "solver")


def relaxation_from_params(prm: Dict[str, Any]):
    kind = str(prm.get("type", "spai0"))
    if kind not in RELAXATION:
        raise ValueError("unknown relaxation %r (have: %s)"
                         % (kind, sorted(RELAXATION)))
    return _build_dataclass(RELAXATION[kind], prm, "precond.relax")


def coarsening_from_params(prm: Dict[str, Any]):
    kind = str(prm.get("type", "smoothed_aggregation"))
    if kind not in COARSENING:
        raise ValueError("unknown coarsening %r (have: %s)"
                         % (kind, sorted(COARSENING)))
    return _build_dataclass(COARSENING[kind], prm, "precond.coarsening")


def _parse_dtype(v):
    return DTYPES[v] if isinstance(v, str) else check_dtype(v)


def _parse_bool(v):
    return v.lower() in ("1", "true", "yes") if isinstance(v, str) else \
        bool(v)


def precond_params_from_dict(prm: Dict[str, Any]) -> AMGParams:
    kw: Dict[str, Any] = {}
    amg_fields = {f.name for f in dataclasses.fields(AMGParams)}
    for k, v in prm.items():
        if k in ("class", "type"):
            continue
        elif k == "coarsening":
            kw["coarsening"] = coarsening_from_params(v)
        elif k == "relax":
            kw["relax"] = relaxation_from_params(v)
        elif k == "dtype":
            kw["dtype"] = _parse_dtype(v)
        elif k in amg_fields:
            if isinstance(v, str) and k in ("coarse_enough", "max_levels",
                                            "npre", "npost", "ncycle",
                                            "pre_cycles"):
                v = int(v)
            if isinstance(v, str) and k == "direct_coarse":
                v = _parse_bool(v)
            kw[k] = v
        else:
            warnings.warn("unknown parameter precond.%s" % k)
    return AMGParams(**kw)


def make_solver_from_config(A, prm=None, block_size: int = 1,
                            refine: int = 0, device=None, device_setup=None,
                            **flat_overrides):
    """The runtime composition entry point.

    ``prm`` is a nested dict, a dict with dotted keys, or a path to a JSON
    file; ``flat_overrides`` are extra ``key=value`` pairs with dotted
    names, e.g. ``make_solver_from_config(A, "cfg.json",
    **{"solver.tol": 1e-10})``. ``block_size > 1`` routes through
    make_block_solver (scalar rhs and x over a block-valued engine).
    ``refine`` goes to ``make_solver`` (the JAX package's entry point has
    no such argument), and so does ``solver.dtype``, as ``solver_dtype``:
    the Krylov loop's dtype where it differs from the preconditioner's,
    as a bfloat16 hierarchy needs (``precond.dtype = "bfloat16"``,
    ``solver.dtype = "float32"``; the JAX package's configuration has no
    such key and runs the loop in the preconditioner's dtype)."""
    cfg = _as_dict(prm)
    if flat_overrides:
        cfg = _deep_merge(cfg, _nest(flat_overrides))
    pcfg = cfg.get("precond", {})
    scfg = dict(cfg.get("solver", {}))
    pclass = str(pcfg.get("class", "amg"))
    sdtype = scfg.pop("dtype", None)
    solver = solver_from_params(scfg)
    kw = dict(device=device, device_setup=device_setup)
    skw = dict(refine=refine, solver_dtype=None if sdtype is None
               else _parse_dtype(sdtype))
    if block_size > 1:
        from amgcl_tpu_torch.models.block_solver import make_block_solver
        if pclass != "amg":
            raise ValueError(
                "block_size > 1 supports precond.class=amg only")
        return make_block_solver(A, block_size,
                                 precond_params_from_dict(pcfg), solver,
                                 **skw, **kw)
    if pclass == "amg":
        return make_solver(A, precond_params_from_dict(pcfg), solver,
                           **skw, **kw)
    return make_solver(A, precond_from_config(A, pcfg, **kw), solver,
                       device=device, **skw)


def precond_from_config(A, pcfg: Dict[str, Any], device=None,
                        device_setup=None):
    """``precond.class``-driven preconditioner construction, recursive for
    ``class=nested`` (reference: amgcl/preconditioner/runtime.hpp:54-423:
    nested wraps a full inner make_solver as the preconditioner,
    configured by its own ``precond.*`` / ``solver.*`` sub-keys)."""
    pclass = str(pcfg.get("class", "amg"))
    dtype = _parse_dtype(pcfg.get("dtype", "float32"))
    kw = dict(device=device, device_setup=device_setup)
    if pclass == "amg":
        return AMG(A, precond_params_from_dict(pcfg), **kw)
    if pclass == "relaxation":
        relax = relaxation_from_params(pcfg.get("relax", {}))
        return AsPreconditioner(A, relax, dtype, device=device)
    if pclass == "dummy":
        return DummyPreconditioner(A, dtype, device=device)
    if pclass == "nested":
        inner = precond_from_config(A, pcfg.get("precond", {}), **kw)
        inner_solver = solver_from_params(pcfg.get("solver", {}))
        # an explicit precond.dtype sets the outer working precision; the
        # default inherits the inner preconditioner's dtype
        return NestedPreconditioner(
            A, inner, inner_solver,
            dtype=dtype if "dtype" in pcfg else None)
    if pclass == "schur":
        from amgcl_tpu_torch.models.schur import SchurPressureCorrection

        def sub(key):
            sc = pcfg.get(key, {})
            prm = precond_params_from_dict(sc.get("precond", {})) \
                if "precond" in sc else None
            sol = solver_from_params(sc["solver"]) if "solver" in sc \
                else None
            return prm, sol

        uprm, usol = sub("usolver")
        pprm, psol = sub("psolver")
        n = A.shape[0]
        return SchurPressureCorrection(
            A, _parse_pmask(pcfg, n), usolver_prm=uprm, psolver_prm=pprm,
            usolver=usol, psolver=psol,
            simplec_dia=_parse_bool(pcfg.get("simplec_dia", True)),
            approx_schur=_parse_bool(pcfg.get("approx_schur", False)),
            adjust_p=int(pcfg.get("adjust_p", 1)), dtype=dtype, **kw)
    if pclass == "cpr":
        from amgcl_tpu_torch.models.cpr import CPR, CPRDRS
        known = {"class", "dtype", "block_size", "pressure", "relax",
                 "weighting", "eps_dd", "eps_ps", "weights", "active_rows"}
        for k in pcfg:
            if k not in known:
                warnings.warn("unknown parameter precond.%s" % k)
        press = dict(pcfg.get("pressure", {}))
        relax = relaxation_from_params(pcfg["relax"]) \
            if "relax" in pcfg else None
        weighting = str(pcfg.get("weighting", "quasi_impes"))
        if weighting not in ("quasi_impes", "drs"):
            raise ValueError("weighting must be 'quasi_impes' or 'drs'")
        cls = CPRDRS if weighting == "drs" else CPR
        return cls(A,
                   block_size=int(pcfg["block_size"])
                   if "block_size" in pcfg else None,
                   pressure_prm=precond_params_from_dict(press)
                   if press else None,
                   relax=relax, dtype=dtype,
                   active_rows=int(pcfg.get("active_rows", 0)),
                   **kw, **_drs_kwargs(pcfg, weighting))
    raise ValueError("unknown precond.class %r" % pclass)


def _drs_kwargs(pcfg, weighting):
    """DRS weighting knobs from a CPR config dict (eps_dd / eps_ps /
    weights — cpr_drs.hpp:88-120); warns when a DRS-only key is set under
    another weighting."""
    drs_keys = [k for k in ("eps_dd", "eps_ps", "weights") if k in pcfg]
    if not drs_keys:
        return {}
    if weighting != "drs":
        warnings.warn(
            "precond.%s only applies to weighting=drs; ignored "
            "under weighting=%s" % ("/".join(drs_keys), weighting))
        return {}
    out = {}
    if "eps_dd" in pcfg:
        out["eps_dd"] = float(pcfg["eps_dd"])
    if "eps_ps" in pcfg:
        out["eps_ps"] = float(pcfg["eps_ps"])
    if "weights" in pcfg:
        out["weights"] = np.asarray(pcfg["weights"], dtype=np.float64)
    return out


def _parse_pmask(pcfg, n):
    """pmask as an explicit array, or the reference's ``pmask_pattern``
    strings: ``%start:stride`` / ``<m`` / ``>m``
    (amgcl/preconditioner/schur_pressure_correction.hpp:141-166)."""
    if "pmask" in pcfg:
        return np.asarray(pcfg["pmask"], dtype=bool)
    pattern = str(pcfg.get("pmask_pattern", ""))
    if not pattern:
        raise ValueError("precond.class=schur needs pmask or pmask_pattern")
    mask = np.zeros(n, dtype=bool)
    if pattern[0] == "%":
        start, stride = pattern[1:].split(":")
        mask[int(start)::int(stride)] = True
    elif pattern[0] == "<":
        mask[:min(int(pattern[1:]), n)] = True
    elif pattern[0] == ">":
        mask[int(pattern[1:]):] = True
    else:
        raise ValueError("unknown pmask_pattern %r" % pattern)
    return mask


def _deep_merge(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
