"""The reference package's cycle arrays as this package's tensors.

Parity tests build one problem with the reference package (kubebatch_tpu)
and hand its arrays, as numpy, to both packages. These helpers are the
only bridge: they take plain numpy arrays (nothing of the reference
package is imported) and return tensors on ``device`` with the dtypes the
port's solve takes, keyed by its argument names. ``engine`` names the
solve: ``"fused"`` (``kernels.fused.fused_allocate``) or ``"batched"``
(``kernels.batched.batched_allocate``; its arrays are the reference's
packed batched inputs unpacked, including task_pair, pair_sig and
pair_nz). :func:`victim_inputs_from_numpy` does the same for the victim
kernels (kernels/victims.py) from the reference solver's host arrays,
the ``affinity_*`` helpers carry the affinity vocabulary
(kernels/affinity.py) and the round engine's affinity arrays, and
:func:`scan_inputs_from_numpy` the per-visit scan's arguments
(``kernels.solver.allocate_scan``), and the ``*_args_from_numpy``
helpers the two-level and active-set solves' (``kernels.hier``,
``kernels.activeset``) from the reference's prepare_hier /
prepare_activeset / prepare_activeset_audit plans, and
:func:`explain_inputs_from_numpy` the unschedulability explainer's
(``obs.explain.explain_counts``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels import batched, fused

#: DeviceSession attribute -> fused_allocate argument
NODE_FIELDS = {"idle": "idle", "releasing": "releasing",
               "backfilled": "backfilled",
               "allocatable_cm": "allocatable_cm", "nz_req": "nz_req0",
               "max_task_num": "max_task_num", "n_tasks": "n_tasks",
               "node_ok": "node_ok"}

_ENGINES = {"fused": fused, "batched": batched}


def _engine(engine: str):
    if engine not in _ENGINES:
        raise ValueError(f"engine {engine!r} is not one of "
                         f"{tuple(_ENGINES)}")
    return _ENGINES[engine]


def _tensor(mod, name: str, arr, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=mod.arg_dtype(name),
                        device=device)


def cycle_inputs_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike, engine: str = "fused"
                            ) -> Dict[str, torch.Tensor]:
    """Every cycle array the ``engine``'s solve reads (its ``CYCLE_ARGS``),
    as tensors on ``device``. ``arrays`` maps field name -> numpy array
    (extra keys are ignored)."""
    mod = _engine(engine)
    dev = resolve_device(device)
    return {n: _tensor(mod, n, arrays[n], dev) for n in mod.CYCLE_ARGS}


def device_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike, engine: str = "fused"
                            ) -> Dict[str, torch.Tensor]:
    """The eight DeviceSession node arrays (keyed by their DeviceSession
    names: idle, releasing, backfilled, allocatable_cm, nz_req, n_tasks,
    max_task_num, node_ok) as tensors on ``device``, keyed by the
    ``engine``'s argument names (fused renames nz_req to nz_req0)."""
    mod = _engine(engine)
    dev = resolve_device(device)
    names = NODE_FIELDS if engine == "fused" else {
        n: n for n in batched.NODE_ARGS}
    return {arg: _tensor(mod, arg, arrays[attr], dev)
            for attr, arg in names.items()}


def affinity_from_numpy(arrays: Mapping[str, np.ndarray],
                        device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The ``aff`` argument of ``kernels.batched.batched_allocate`` from
    the reference's packed batched arrays (its names: node_dom, task_grp,
    ..., aff_grp_cnt0, ..., and task_ports / port_base / aff_ip_weight
    when present), as tensors on ``device``."""
    dev = resolve_device(device)
    names = batched.AFF_ARGS + tuple(
        n for n in batched.PORT_ARGS + (batched.IP_ARG,) if n in arrays)
    return {n: _tensor(batched, n, arrays[n], dev) for n in names}


def affinity_state_from_numpy(arrays: Mapping[str, np.ndarray],
                              device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The affinity members of the round engine's RoundState and
    CycleArrays (the reference's names: aff_grp_cnt, aff_anti_cnt,
    aff_pref_w, aff_grp_total, port_claim; node_dom, task_grp, ...,
    task_ports, port_base, ip_weight) that ``arrays`` holds, as tensors
    on ``device`` with the port's dtypes."""
    dev = resolve_device(device)
    dtypes = {"aff_grp_cnt": torch.float32, "aff_anti_cnt": torch.float32,
              "aff_pref_w": torch.float32, "aff_grp_total": torch.float32,
              "port_claim": torch.bool, "ip_weight": torch.float32}
    out = {}
    for name, arr in arrays.items():
        if arr is None:
            continue
        dt = dtypes.get(name) or batched.arg_dtype(name)
        out[name] = torch.tensor(np.asarray(arr), dtype=dt, device=dev)
    return out


def affinity_inputs_from_numpy(fields: Mapping[str, object]):
    """A ``kernels.affinity.AffinityInputs`` from the reference's
    AffinityInputs fields (``WIRE_FIELDS`` arrays, ``ip_weight``,
    ``ip_enabled``): numpy, the host encoder's form."""
    from .kernels.affinity import WIRE_FIELDS, AffinityInputs

    kw = {n: np.array(fields[n]) for n in WIRE_FIELDS}
    return AffinityInputs(ip_weight=float(fields["ip_weight"]),
                          ip_enabled=bool(fields["ip_enabled"]), **kw)


def victim_inputs_from_numpy(static: Sequence[np.ndarray],
                             mutable: Sequence[np.ndarray],
                             sig: Sequence[np.ndarray],
                             lanes: Sequence[np.ndarray],
                             device: DeviceLike,
                             visited: Optional[np.ndarray] = None
                             ) -> Dict[str, torch.Tensor]:
    """Every argument of ``kernels.victims.victim_wave`` (and, with
    ``visited``, of ``victim_visit``) as tensors on ``device``, from a
    victim solver's ``host_static_arrays()`` (18 arrays),
    ``host_mutable_arrays()`` (6), ``host_sig_arrays()`` (2; a bfloat16
    score matrix upcasts exactly to float32) and the six lane arrays
    (p_res, p_resreq, p_nz, p_sig, p_job, p_queue; a single visit's
    scalars become one lane). The per-node row order the kernels read is
    derived from v_node and v_live here."""
    from .kernels import victims

    dev = resolve_device(device)
    arrays = dict(zip(victims.STATIC_ARGS, static))
    arrays.update(zip(victims.MUTABLE_ARGS, mutable))
    arrays.update(zip(victims.SIG_ARGS, sig))
    widths = {"p_res": 3, "p_resreq": 3, "p_nz": 2}
    for name, arr in zip(victims.LANE_ARGS, lanes):
        arr = np.asarray(arr)
        arrays[name] = arr.reshape(-1, widths[name]) if name in widths \
            else arr.reshape(-1)
    n_pad = np.asarray(arrays["node_ok"]).shape[0]
    arrays.update(zip(victims.ORDER_ARGS, victims.node_row_order(
        np.asarray(arrays["v_node"], np.int32),
        np.asarray(arrays["v_live"], bool), n_pad)))
    if visited is not None:
        arrays["visited"] = visited
    out = {}
    for name, arr in arrays.items():
        dt = victims.arg_dtype(name)
        a = np.asarray(arr)
        if dt == torch.float32:
            a = a.astype(np.float32)
        out[name] = torch.tensor(a, dtype=dt, device=dev)
    return out


def scan_inputs_from_numpy(arrays: Mapping[str, object],
                           device: DeviceLike) -> Dict[str, object]:
    """Every argument of ``kernels.solver.allocate_scan`` from numpy,
    keyed by its names (``kernels.solver.SCAN_ARGS``: the node carry and
    state, the task batch, the [T, N] score and predicate rows, the
    readiness scalars and the nodeorder weights): tensors on ``device``
    with the scan's dtypes, ``min_available`` / ``init_allocated`` as
    Python ints."""
    from .kernels import solver

    dev = resolve_device(device)
    out: Dict[str, object] = {}
    for name in solver.SCAN_ARGS:
        if name in ("min_available", "init_allocated"):
            out[name] = int(np.asarray(arrays[name]))
        else:
            dt = torch.float32 if name == "dyn_weights" \
                else solver.scan_arg_dtype(name)
            out[name] = torch.tensor(np.asarray(arrays[name]), dtype=dt,
                                     device=dev)
    return out


# ---- the two-level and active-set solves ------------------------------------

#: the statics the reference's plans and the port's solves share
_SOLVE_STATICS = ("job_keys", "queue_keys", "prop_overused", "dyn_enabled",
                  "pipe_enabled", "max_rounds", "pool_size", "max_waves",
                  "gang_enabled", "narrow", "narrow_gate")


def _unpack_np(bufs: Sequence[np.ndarray], lays) -> Dict[str, np.ndarray]:
    out = {}
    for buf, lay in zip(bufs, lays):
        buf = np.asarray(buf)
        for name, off, shape in lay:
            size = int(np.prod(shape)) if shape else 1
            out[name] = buf[off:off + size].reshape(shape)
    return out


def _solve_tensors(arrays: Mapping[str, np.ndarray], names,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    return {n: _tensor(batched, n, arrays[n], device) for n in names}


def _node_tensors(node: Sequence[np.ndarray], device: torch.device):
    return _solve_tensors(dict(zip(batched.NODE_ARGS, node)),
                          batched.NODE_ARGS, device)


def _cycle_tensors(bufs, lays, device, pair_init: bool = False):
    arrays = _unpack_np(bufs, lays)
    out = _solve_tensors(arrays, batched.CYCLE_ARGS, device)
    if pair_init:
        out["pair_init"] = torch.tensor(
            np.asarray(arrays["pair_init_resreq"]), dtype=torch.float32,
            device=device)
    return out


def hier_args_from_numpy(args: Sequence[np.ndarray],
                         statics: Mapping[str, object], device: DeviceLike,
                         pair_init: bool = False):
    """The (arrays, statics) of ``kernels.hier.hier_packed`` from the
    reference's ``prepare_hier`` plan: ``args`` its eleven arrays as
    numpy (three packed buffers, then the eight node arrays), ``statics``
    its static arguments (the buffers' layouts among them)."""
    dev = resolve_device(device)
    arrays = _node_tensors(args[3:11], dev)
    arrays.update(_cycle_tensors(args[:3], (statics["lay_f"],
                                            statics["lay_i"],
                                            statics["lay_b"]), dev,
                                 pair_init))
    return arrays, {k: statics[k] for k in _SOLVE_STATICS if k in statics}


def activeset_args_from_numpy(args: Sequence[np.ndarray],
                              statics: Mapping[str, object],
                              device: DeviceLike):
    """The (arrays, statics) of ``kernels.activeset.activeset_packed``
    from the reference's ``prepare_activeset`` plan (args, statics): the
    regrained task axis and the pair representatives (``pair_init``)
    carried across."""
    return hier_args_from_numpy(args, statics, device, pair_init=True)


def activeset_audit_args_from_numpy(args: Sequence[np.ndarray],
                                    statics: Mapping[str, object],
                                    device: DeviceLike):
    """(node, act, full, statics) of
    ``kernels.activeset.activeset_audit_packed`` from the reference's
    ``prepare_activeset_audit`` plan: ``args`` its fourteen arrays as
    numpy (the active set's three buffers, the full width's three, the
    eight node arrays)."""
    dev = resolve_device(device)
    node = _node_tensors(args[6:14], dev)
    act = _cycle_tensors(args[:3], (statics["alay_f"], statics["alay_i"],
                                    statics["alay_b"]), dev, pair_init=True)
    full = _cycle_tensors(args[3:6], (statics["flay_f"], statics["flay_i"],
                                      statics["flay_b"]), dev)
    st = {k: statics[k] for k in _SOLVE_STATICS if k in statics}
    st.update(amax_rounds=statics["amax_rounds"],
              max_rounds=statics["fmax_rounds"])
    return node, act, full, st


def explain_inputs_from_numpy(arrays: Mapping[str, np.ndarray],
                              device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The reference explainer's ``_explain_kernel`` arguments (numpy,
    keyed by its argument names) as explain_counts' contiguous tensors
    on ``device``."""
    from .obs.explain import ARG_DTYPES

    dev = resolve_device(device)
    return {n: torch.tensor(np.ascontiguousarray(arrays[n]), dtype=dt,
                            device=dev)
            for n, dt in ARG_DTYPES}
