"""Actions layer of the PyTorch port: the action vocabulary (schemas,
validation, consensus merge rules), as data and pure logic. Execution
(routers, executors) is not ported yet."""

from quoracle_tpu_torch.actions.schema import (  # noqa: F401
    ACTIONS,
    ActionSchema,
    batchable_async_actions,
    batchable_sync_actions,
    get_schema,
)
