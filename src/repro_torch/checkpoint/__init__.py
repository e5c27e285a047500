"""Checkpoints of the port (twin of the JAX package's ``checkpoint``): the
atomic msgpack tree file (`ckpt`) and preemption-safe resumable runs
(`resume`).  The files are the reference's: either package reads the
other's."""
from repro_torch.checkpoint.ckpt import (CheckpointError, load_checkpoint,
                                         save_checkpoint, validate_leaves)
from repro_torch.checkpoint.resume import (RunCheckpoint, RunCheckpointer,
                                           SectionCheckpoint,
                                           as_checkpointer, pack_controller,
                                           restore_run, save_run,
                                           unpack_controller)

__all__ = [
    "CheckpointError", "load_checkpoint", "save_checkpoint",
    "validate_leaves", "RunCheckpoint", "RunCheckpointer",
    "SectionCheckpoint", "as_checkpointer", "pack_controller",
    "restore_run", "save_run", "unpack_controller",
]
