"""The paper's three real-world workloads (§7): BMI, IMS, KCS.

Each workload compiles its bulk bitwise expression with the *actual*
Flash-Cosmos planner (``repro_torch.core.planner``) against the paper's placement
policy, so the simulated FC command counts come from the same code path that
executes on the engine — not from a hand-derived formula.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.commands import MWSCommand, ThresholdCommand
from repro_torch.core.expr import Page, and_, or_
from repro_torch.core.placement import Layout
from repro_torch.core.planner import Planner


@dataclass(frozen=True)
class MWSCommandShape:
    """What the timing model needs to know about one MWS command.

    ``threshold_k > 0`` marks a k-of-N threshold sensing (§ESP-style
    one-shot vote across blocks): same wordline-select setup as MWS, but
    the timing model prices the staircase sense-amp reference sweep via
    :func:`repro_torch.flashsim.timing.threshold_latency_us` instead of the
    plain inter-block read.  ``0`` (the default) is an ordinary MWS read.
    """

    n_blocks: int
    max_wls_per_block: int
    threshold_k: int = 0


@dataclass(frozen=True)
class BulkBitwiseWorkload:
    name: str
    num_operands: int  # operand vectors sensed per query (PB/OSP/ISP path)
    operand_bits: int  # bits per operand vector
    result_bits: int  # result bits transferred to host, per query
    num_queries: int = 1
    host_postprocess: bool = False  # e.g. BMI bit-count on the host
    fc_commands: tuple[MWSCommandShape, ...] = field(default_factory=tuple)
    # weighted alternative to fc_commands for long traces: (shape, count)
    # pairs keep the workload O(distinct shapes) instead of O(commands)
    fc_command_counts: tuple[tuple[MWSCommandShape, int], ...] = field(
        default_factory=tuple
    )
    # sanity metadata
    fc_sensing_ops: int = 0

    @property
    def fc_command_pairs(self) -> tuple[tuple[MWSCommandShape, int], ...]:
        if self.fc_command_counts:
            return self.fc_command_counts
        return tuple((s, 1) for s in self.fc_commands)


def _shapes_from_plan(plan) -> tuple[MWSCommandShape, ...]:
    shapes = []
    for c in plan.commands:
        if isinstance(c, MWSCommand):
            shapes.append(
                MWSCommandShape(
                    n_blocks=c.num_blocks,
                    max_wls_per_block=max(
                        len(t.wordlines) for t in c.targets
                    ),
                    threshold_k=getattr(c, "k", 0)
                    if isinstance(c, ThresholdCommand)
                    else 0,
                )
            )
    return tuple(shapes)


def bmi_workload(months: int, users: int = 800_000_000) -> BulkBitwiseWorkload:
    """Bitmap Index: AND over d daily activity vectors + host bit-count.

    d = days in the past ``months`` months (paper: 30 … 1095 operands for
    m = 1 … 36); vectors of one bit per user.
    """
    d = round(30.4166 * months)
    layout = Layout()
    names = [f"day{i}" for i in range(d)]
    layout.place_colocated(names, inverted=False)  # §6.3 placement rule
    expr = and_(*map(Page, names))
    plan = Planner(layout).compile(expr)
    return BulkBitwiseWorkload(
        name=f"BMI(m={months})",
        num_operands=d,
        operand_bits=users,
        result_bits=users,
        num_queries=1,
        host_postprocess=True,  # bit-count overlapped with result transfer
        fc_commands=_shapes_from_plan(plan),
        fc_sensing_ops=plan.num_sensing_ops,
    )


def ims_workload(images: int) -> BulkBitwiseWorkload:
    """Image Segmentation: Y·U·V bitwise AND over three bit vectors of
    images × 800 × 600 pixels × 4 colors bits each."""
    bits = images * 800 * 600 * 4
    layout = Layout()
    names = ["Y", "U", "V"]
    layout.place_colocated(names, inverted=False)
    plan = Planner(layout).compile(and_(*map(Page, names)))
    return BulkBitwiseWorkload(
        name=f"IMS(I={images})",
        num_operands=3,
        operand_bits=bits,
        result_bits=bits,
        num_queries=1,
        host_postprocess=False,
        fc_commands=_shapes_from_plan(plan),
        fc_sensing_ops=plan.num_sensing_ops,
    )


def kcs_workload(
    k: int, vertices: int = 32_000_000, cliques: int = 1024
) -> BulkBitwiseWorkload:
    """K-Clique Star listing: per clique, AND of the k members' adjacency
    vectors OR'd with the clique's own vector — both ops in one inter-block
    MWS when the clique vector lives in a different block (paper §7)."""
    layout = Layout()
    adj = [f"adj{i}" for i in range(k)]
    layout.place_colocated(adj, inverted=False)
    layout.place_spread(["clique"])
    expr = or_(and_(*map(Page, adj)), Page("clique"))
    plan = Planner(layout).compile(expr)
    return BulkBitwiseWorkload(
        name=f"KCS(k={k})",
        num_operands=k + 1,
        operand_bits=vertices,
        result_bits=vertices,
        num_queries=cliques,
        host_postprocess=False,
        fc_commands=_shapes_from_plan(plan),
        fc_sensing_ops=plan.num_sensing_ops,
    )
