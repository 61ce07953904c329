"""FlashQL on PyTorch: the batched bitmap-index query-serving subsystem.

The port's mirror of ``repro.query``: serving through
:class:`BatchScheduler` on one device, with every aggregate (COUNT, MASK,
SUM, AVG, MIN, MAX, TOP-K, GROUP BY), over a live index (append, delete,
update, compact), and over a fleet of devices striped by rows
(:class:`ShardedFlashQL`).

* :mod:`repro_torch.query.ast` — the predicate AST and aggregate specs;
* :mod:`repro_torch.query.aggregate` — the aggregation pipeline;
* :mod:`repro_torch.query.bitmap` — ``BitmapStore``: ingests columnar
  tables into equality bitmaps and bit-sliced range indexes;
* :mod:`repro_torch.query.compile` — lowering, the plan cache, and the
  fused flush compiler;
* :mod:`repro_torch.query.device` — ``FlashDevice``: batched execution on
  the gather-reduce, threshold and popcount kernels;
* :mod:`repro_torch.query.scheduler` — ``BatchScheduler``;
* :mod:`repro_torch.query.shard` — ``ShardedBitmapStore`` and
  ``ShardedFlashQL``: the sharded fleet, its snapshots in one fleet tensor;
* :mod:`repro_torch.query.state` — loading a reference deployment's state
  (one device or a sharded fleet);
* :mod:`repro_torch.query.telemetry` — the metrics registry and traces.
"""

from repro_torch.query.aggregate import (
    Aggregator,
    get_aggregator,
    validate_query,
)
from repro_torch.query.ast import (
    Agg,
    And,
    AtLeast,
    Avg,
    Count,
    Eq,
    GroupBy,
    In,
    Majority,
    Mask,
    Max,
    Min,
    Not,
    Or,
    Query,
    Range,
    Sum,
    TopK,
)
from repro_torch.query.bitmap import (
    VALID_PAGE,
    AppendDelta,
    BitmapStore,
    PageDelta,
)
from repro_torch.query.compile import (
    CompiledQuery,
    FlushProgram,
    QueryCompiler,
    compile_flush,
    lower,
)
from repro_torch.query.device import FlashDevice
from repro_torch.query.scheduler import BatchScheduler, QueryResult
from repro_torch.query.shard import (
    ShardedBitmapStore,
    ShardedFlashQL,
    build_sharded_flashql,
)
from repro_torch.query.state import (
    export_fleet_state,
    export_state,
    load_reference_fleet,
    load_reference_state,
)
from repro_torch.query.telemetry import (
    Histogram,
    Telemetry,
    percentile,
    validate_trace,
)

__all__ = [
    "Agg",
    "Aggregator",
    "And",
    "AtLeast",
    "Majority",
    "Avg",
    "Count",
    "Eq",
    "GroupBy",
    "In",
    "Mask",
    "Max",
    "Min",
    "Not",
    "Or",
    "Query",
    "Range",
    "Sum",
    "TopK",
    "get_aggregator",
    "validate_query",
    "AppendDelta",
    "BitmapStore",
    "PageDelta",
    "VALID_PAGE",
    "CompiledQuery",
    "FlushProgram",
    "QueryCompiler",
    "compile_flush",
    "lower",
    "FlashDevice",
    "BatchScheduler",
    "QueryResult",
    "ShardedBitmapStore",
    "ShardedFlashQL",
    "build_sharded_flashql",
    "export_state",
    "load_reference_state",
    "export_fleet_state",
    "load_reference_fleet",
    "Histogram",
    "Telemetry",
    "percentile",
    "validate_trace",
]
