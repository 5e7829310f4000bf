"""Constants and environment flags of the port.

Own copy of the parts of ``autodist_tpu/const.py`` the port uses: the
working directories, the mesh axis names, the batch-mask key, the default
bucket size, the ``ENV`` entries the chief/worker strategy hand-off reads,
and the launcher's rank environment (``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, or an
``AUTODIST_INIT_METHOD`` such as ``file:///path``).
"""
import os
from enum import Enum

DEFAULT_WORKING_DIR = os.path.join(os.environ.get("TMPDIR", "/tmp"), "autodist_tpu_torch")
DEFAULT_SERIALIZATION_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")

# Mesh axis names (the JAX package's; "replica" is the data-parallel axis).
AXIS_REPLICA = "replica"
AXIS_MODEL = "model"
AXIS_PIPELINE = "pipe"
AXIS_SEQUENCE = "seq"
AXIS_EXPERT = "expert"
AXIS_REPLICA_DCN = "replica_dcn"
AXIS_REPLICA_ICI = "replica_ici"

# Reserved batch key of the per-example validity mask (uneven global batches).
BATCH_MASK_KEY = "__batch_mask__"

# Default gradient bucket size in bytes.
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024


class ENV(Enum):
    """Environment variables with typed accessors (read at each ``.val``)."""

    AUTODIST_WORKER = (lambda v: v or "",)
    AUTODIST_STRATEGY_ID = (lambda v: v or "",)
    AUTODIST_MIN_LOG_LEVEL = (lambda v: v or "INFO",)
    AUTODIST_IS_TESTING = (lambda v: v == "True" or v == "1",)
    # one process per replica, as torchrun launches them
    RANK = (lambda v: int(v or 0),)
    WORLD_SIZE = (lambda v: int(v or 1),)
    LOCAL_RANK = (lambda v: int(v or 0),)
    MASTER_ADDR = (lambda v: v or "",)
    MASTER_PORT = (lambda v: v or "",)
    AUTODIST_INIT_METHOD = (lambda v: v or "",)

    @property
    def val(self):
        """Return the typed value of this env var in the current process."""
        (caster,) = self.value
        return caster(os.environ.get(self.name))


IS_AUTODIST_CHIEF = not ENV.AUTODIST_WORKER.val
