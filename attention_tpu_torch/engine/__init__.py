"""The port's continuous-batching serving engine (single device, one
packed ragged kernel launch per layer per step), with its snapshots and
write-ahead journal."""

from attention_tpu_torch.engine.allocator import (  # noqa: F401
    BlockAllocator,
    pages_for_tokens,
)
from attention_tpu_torch.engine.engine import (  # noqa: F401
    EngineConfig,
    ServingEngine,
)
from attention_tpu_torch.engine.errors import (  # noqa: F401
    DeadlineExceededError,
    SnapshotCorruptError,
    SnapshotError,
    StepLimitExceededError,
)
from attention_tpu_torch.engine.journal import (  # noqa: F401
    Journal,
    apply_journal,
)
from attention_tpu_torch.engine.metrics import (  # noqa: F401
    EngineMetrics,
    RequestMetrics,
    StepMetrics,
)
from attention_tpu_torch.engine.request import (  # noqa: F401
    TERMINAL_STATES,
    Request,
    RequestState,
    SamplingParams,
)
from attention_tpu_torch.engine.scheduler import (  # noqa: F401
    ScheduledStep,
    Scheduler,
)
from attention_tpu_torch.engine.sim import (  # noqa: F401
    bursty_trace,
    diurnal_trace,
    load_trace,
    replay,
    sampling_of,
    save_trace,
    synthetic_trace,
)
from attention_tpu_torch.engine.snapshot import (  # noqa: F401
    SnapshotManager,
    recover_engine,
    state_fingerprint,
)
