"""Roofline terms and the analytic scaling curves the fleet arbiter values
devices by.

  compute term    = HLO_FLOPs / (chips × peak_FLOP/s)
  memory term     = HLO_bytes / (chips × HBM_bw)
  collective term = collective_bytes / (chips × link_bw)

A copy of the JAX package's ``roofline/analysis.py`` that reads the peak
rate, the HBM rate and the link rate from the port's ``launch/mesh.py``
(one H100 SXM) where the JAX file reads a TPU v5e's. The JAX package fills
the terms from a compiled dry run: HLO_FLOPs and HLO_bytes from XLA's
``cost_analysis()``, the collective bytes parsed from its optimized HLO
text. The port compiles no HLO, so :func:`collective_bytes_from_hlo` stays
what it is, a parser of XLA's HLO text, kept so that the same text gives
the same bytes in both packages. The port's dry run (``launch/dryrun.py``)
fills HLO_FLOPs and HLO_bytes from one execution on the meta device
(``roofline/counting.py``); it does not yet run the per-rank step under
the mock groups (``core/mock_groups.py``), whose records would give the
collectives, so it leaves ``collective_bytes`` and ``per_collective`` None:
the collective term is then None, and the bottleneck and the roofline
fraction are taken over the two counted terms. The analytic curves at the end
(``analytic_step_time``, ``analytic_throughput``, ``marginal_throughput``)
read a ``sim.cluster.ClusterModel``, not these constants.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# e.g.  "%all-reduce.42 = f32[512,1024]{1,0} all-reduce(...)"
#       "... = (f32[8,128]{1,0}, f32[8,128]{1,0}) all-to-all(...)"
_OP_LINE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+([a-z\-]+)\("
)
_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE.finditer(text):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> dict[str, int]:
    """Per-op-kind wire-byte totals, per chip.

    Shapes in partitioned HLO are per-participant, so result-shape bytes are
    already per-chip. Wire-cost weights (ring-algorithm approximations):
      all-gather          ≈ 1× result bytes   ((n-1)/n ≈ 1)
      all-reduce          ≈ 2× result bytes   (reduce-scatter + all-gather)
      reduce-scatter      ≈ 1× operand bytes  (parsed from the call args)
      all-to-all          ≈ 1× result bytes
      collective-permute  = 1× result bytes
    """
    out: dict[str, int] = {k: 0 for k in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        m = _OP_LINE.search(line)
        if not m:
            continue
        shape_txt, op = m.group(1), m.group(2)
        if op.endswith("-start"):
            op = op[: -len("-start")]
        if op not in out:
            continue
        if op == "reduce-scatter":
            # operand shapes appear inside the call parens
            paren = line[line.index(op) + len(op):]
            out[op] += _shape_bytes(paren)
        elif op == "all-reduce":
            out[op] += 2 * _shape_bytes(shape_txt)
        else:
            out[op] += _shape_bytes(shape_txt)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: int | None  # None: not counted
    per_collective: dict | None = field(default_factory=dict)
    model_flops: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float | None:
        # global wire bytes over aggregate link bandwidth (assignment form)
        if self.collective_bytes is None:
            return None
        return self.collective_bytes / (self.chips * ICI_BW)

    def _terms(self) -> dict:
        """The counted terms by name (the collective one where counted)."""
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the dominant term allows, for *useful* FLOPs:
        model_flops_time / max(term)s."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS_BF16)
        worst = max(self._terms().values())
        return ideal / worst if worst else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "per_collective": self.per_collective,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(
    arch: str,
    shape: str,
    mesh_desc: str,
    chips: int,
    cost_analysis: dict,
    hlo_text: str,
    model_flops: float,
) -> RooflineReport:
    per = collective_bytes_from_hlo(hlo_text)
    flops = float(cost_analysis.get("flops", 0.0))
    nbytes = float(cost_analysis.get("bytes accessed", 0.0))
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=nbytes,
        collective_bytes=int(sum(per.values())),
        per_collective=per,
        model_flops=model_flops,
    )


# ---------------------------------------------------------------------------
# Analytic scaling curves (fleet arbitration value function, DESIGN.md §18)
# ---------------------------------------------------------------------------

# At the calibration point the collective term is a fixed fraction of the
# step — the paper's measured DP overhead at full scale (§6.3's sub-1%
# steady overhead excludes gradient sync; profile-level splits on the
# testbed put allreduce near 15% of the iteration).
_COLLECTIVE_FRACTION = 0.15


def analytic_step_time(
    params: float, world: int, cluster, ref_world: int = 32
) -> float:
    """Roofline-style step-time decomposition for a ``params``-sized job
    on ``world`` devices of ``cluster`` (a ``sim.cluster.ClusterModel``).

    The calibrated ``cluster.step_time_s`` at ``ref_world`` anchors the
    magnitude; the split follows the roofline terms above: the compute
    term shards perfectly (∝ 1/world) while the data-parallel gradient
    all-reduce follows the ring cost ∝ (world-1)/world — asymptotically
    FLAT in world. Throughput per device therefore *falls* as a job
    grows, which is the concavity the fleet arbiter's marginal-value
    function needs: past the knee, the next device is worth more to a
    smaller job.
    """
    if world <= 0:
        return float("inf")
    base = cluster.step_time_s(params, ref_world, ref_world=ref_world)
    comp_1dev = base * (1.0 - _COLLECTIVE_FRACTION) * ref_world
    ring_coeff = base * _COLLECTIVE_FRACTION * ref_world / (ref_world - 1)
    return comp_1dev / world + ring_coeff * (world - 1) / world


def analytic_throughput(
    params: float,
    world: int,
    cluster,
    global_batch: int,
    ref_world: int = 32,
) -> float:
    """Samples/second of the job at ``world`` devices (0 when idle)."""
    if world <= 0:
        return 0.0
    return global_batch / analytic_step_time(params, world, cluster, ref_world)


def marginal_throughput(
    params: float,
    world: int,
    cluster,
    global_batch: int,
    delta: int = 1,
    ref_world: int = 32,
) -> float:
    """Samples/second per *additional device* for growing ``world`` by
    ``delta`` — the fleet arbiter's value function (strictly decreasing
    in ``world`` under the ring model above)."""
    if delta <= 0:
        return 0.0
    lo = analytic_throughput(params, world, cluster, global_batch, ref_world)
    hi = analytic_throughput(
        params, world + delta, cluster, global_batch, ref_world
    )
    return (hi - lo) / delta
