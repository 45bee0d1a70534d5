"""Actions layer of the PyTorch port: the action vocabulary (schemas,
validation, consensus merge rules) and its execution (the per-action
router in router.py, the executors in executors.py, and the world-facing
ones in world.py: fetch_web, call_api, call_mcp, answer_engine,
generate_images)."""

from quoracle_tpu_torch.actions.schema import (  # noqa: F401
    ACTIONS,
    ActionSchema,
    batchable_async_actions,
    batchable_sync_actions,
    get_schema,
)

# Executor registration side effects: importing this fills EXECUTORS.
from quoracle_tpu_torch.actions import executors as _executors  # noqa: E402,F401
from quoracle_tpu_torch.actions import world as _world  # noqa: E402,F401
