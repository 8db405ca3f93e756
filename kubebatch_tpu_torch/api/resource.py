"""Dense resource vector with the reference's epsilon-comparison semantics.

ref: pkg/scheduler/api/resource_info.go. The fit decisions of every action
depend on these epsilons (minMilliCPU=10, minMemory=10MiB, minMilliGPU=10,
resource_info.go:54-56), so they are reproduced exactly. This struct is the
row type of the dense node/task tensors the device solver consumes
(see kernels/tensorize.py): ``to_vec()`` defines the canonical [cpu, mem,
gpu] axis order and the MiB memory scaling used on device.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

from ..objects import CPU, GPU, MEMORY, PODS

# epsilons (ref: resource_info.go:54-56)
MIN_MILLI_CPU = 10.0
MIN_MILLI_GPU = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

#: canonical dense axis order for device tensors
RESOURCE_NAMES: List[str] = [CPU, MEMORY, GPU]
RESOURCE_DIM = len(RESOURCE_NAMES)

#: host->device unit scaling: memory is carried in MiB on device so float32
#: stays exact at cluster scale; with this scaling every epsilon is 10.0.
VEC_SCALE = np.array([1.0, 1.0 / (1024 * 1024), 1.0], dtype=np.float64)
VEC_EPS = (np.array([MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_GPU],
                    dtype=np.float64) * VEC_SCALE).astype(np.float32)


class Resource:
    """Mutable resource vector {milli_cpu, memory(bytes), milli_gpu}.

    ``max_task_num`` is only consulted by predicates, never by arithmetic
    (ref: resource_info.go:30-32).
    """

    __slots__ = ("milli_cpu", "memory", "milli_gpu", "max_task_num")

    def __init__(self, milli_cpu: float = 0.0, memory: float = 0.0,
                 milli_gpu: float = 0.0, max_task_num: int = 0):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.milli_gpu = float(milli_gpu)
        self.max_task_num = int(max_task_num)

    # --- constructors -----------------------------------------------------
    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Dict[str, float]) -> "Resource":
        """ref: resource_info.go:58-73 (NewResource). Keyed gets instead of
        a key loop (dict keys are unique, so the reference's += per seen key
        reduces to one get per known resource); runs O(nodes+tasks) times
        per snapshot."""
        r = object.__new__(cls)
        if rl:
            r.milli_cpu = float(rl.get(CPU, 0.0))
            r.memory = float(rl.get(MEMORY, 0.0))
            r.milli_gpu = float(rl.get(GPU, 0.0))
            r.max_task_num = int(rl.get(PODS, 0))
        else:
            r.milli_cpu = 0.0
            r.memory = 0.0
            r.milli_gpu = 0.0
            r.max_task_num = 0
        return r

    def clone(self) -> "Resource":
        # bypasses __init__ — clones run O(tasks) times per cycle and the
        # fields are known-normalized already
        r = object.__new__(Resource)
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.milli_gpu = self.milli_gpu
        r.max_task_num = self.max_task_num
        return r

    # --- mutating arithmetic (reference style; return self for chaining) --
    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        self.milli_gpu += rr.milli_gpu
        return self

    def sub(self, rr: "Resource") -> "Resource":
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        self.milli_gpu -= rr.milli_gpu
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        self.milli_gpu *= ratio
        return self

    def set_max(self, rr: "Resource") -> "Resource":
        """Per-dimension max, in place (ref: resource_info.go:114-128)."""
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        self.milli_gpu = max(self.milli_gpu, rr.milli_gpu)
        return self

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Available-minus-requested with epsilon padding; any negative field
        flags an insufficient dimension (ref: resource_info.go:134-147).
        Dimensions the request doesn't touch are left unchanged."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        if rr.milli_gpu > 0:
            self.milli_gpu -= rr.milli_gpu + MIN_MILLI_GPU
        return self

    def add_vec(self, vec) -> "Resource":
        """In-place add of a [cpu_milli, mem, gpu_milli] triple in HOST
        units — the bulk decision replays apply per-node/per-job numpy
        sums through this instead of hand-unrolling the axis order."""
        self.milli_cpu += vec[0]
        self.memory += vec[1]
        self.milli_gpu += vec[2]
        return self

    def sub_vec(self, vec) -> "Resource":
        self.milli_cpu -= vec[0]
        self.memory -= vec[1]
        self.milli_gpu -= vec[2]
        return self

    # --- non-mutating sugar ----------------------------------------------
    def plus(self, rr: "Resource") -> "Resource":
        return self.clone().add(rr)

    def minus(self, rr: "Resource") -> "Resource":
        return self.clone().sub(rr)

    # --- comparisons (epsilon semantics, ref: resource_info.go:75-168) ----
    def is_empty(self) -> bool:
        return (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY
                and self.milli_gpu < MIN_MILLI_GPU)

    def is_below_zero(self) -> bool:
        return self.milli_cpu <= 0 and self.memory <= 0 and self.milli_gpu <= 0

    def is_zero(self, name: str) -> bool:
        if name == CPU:
            return self.milli_cpu < MIN_MILLI_CPU
        if name == MEMORY:
            return self.memory < MIN_MEMORY
        if name == GPU:
            return self.milli_gpu < MIN_MILLI_GPU
        raise ValueError(f"unknown resource {name!r}")

    def less(self, rr: "Resource") -> bool:
        """Strict < on EVERY dimension (ref: resource_info.go:156-158)."""
        return (self.milli_cpu < rr.milli_cpu and self.memory < rr.memory
                and self.milli_gpu < rr.milli_gpu)

    def less_equal(self, rr: "Resource") -> bool:
        """<= within epsilon on every dimension (ref: resource_info.go:164-168).
        THE fit test used by allocate/backfill/preempt/reclaim."""
        return ((self.milli_cpu < rr.milli_cpu
                 or abs(rr.milli_cpu - self.milli_cpu) < MIN_MILLI_CPU)
                and (self.memory < rr.memory
                     or abs(rr.memory - self.memory) < MIN_MEMORY)
                and (self.milli_gpu < rr.milli_gpu
                     or abs(rr.milli_gpu - self.milli_gpu) < MIN_MILLI_GPU))

    def equal(self, rr: "Resource") -> bool:
        return (self.milli_cpu == rr.milli_cpu and self.memory == rr.memory
                and self.milli_gpu == rr.milli_gpu)

    def get(self, name: str) -> float:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if name == GPU:
            return self.milli_gpu
        raise ValueError(f"unsupported resource {name!r}")

    # --- tensorization ----------------------------------------------------
    def to_vec(self) -> np.ndarray:
        """Dense [cpu_milli, mem_MiB, gpu_milli] float32 row for the solver."""
        raw = np.array([self.milli_cpu, self.memory, self.milli_gpu],
                       dtype=np.float64)
        return (raw * VEC_SCALE).astype(np.float32)

    def __eq__(self, other) -> bool:  # structural equality for tests
        return (isinstance(other, Resource) and self.equal(other)
                and self.max_task_num == other.max_task_num)

    def __repr__(self) -> str:
        return (f"Resource(cpu={self.milli_cpu:.2f}m, "
                f"mem={self.memory:.0f}B, gpu={self.milli_gpu:.2f}m)")


def resource_names() -> List[str]:
    return list(RESOURCE_NAMES)


def res_min(l: Resource, r: Resource) -> Resource:
    """Per-dimension min (ref: api/helpers/helpers.go:216-224)."""
    return Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory),
                    min(l.milli_gpu, r.milli_gpu))


def share(l: float, r: float) -> float:
    """l/r with the reference's conventions 0/0 -> 0, x/0 -> 1
    (ref: api/helpers/helpers.go:226-239)."""
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return l / r


def dominant_share(alloc: "Resource", denom: "Resource") -> float:
    """max over the resource dimensions of share(alloc, denom) — the DRF /
    proportion share formula, unrolled (it runs once per allocation
    event)."""
    return max(share(alloc.milli_cpu, denom.milli_cpu),
               share(alloc.memory, denom.memory),
               share(alloc.milli_gpu, denom.milli_gpu))


def vecs(resources: Iterable[Resource]) -> np.ndarray:
    """Stack Resources into an [n, RESOURCE_DIM] float32 matrix."""
    rows = [r.to_vec() for r in resources]
    if not rows:
        return np.zeros((0, RESOURCE_DIM), dtype=np.float32)
    return np.stack(rows)
