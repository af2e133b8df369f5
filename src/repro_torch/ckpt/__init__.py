"""Flat-npz checkpoints in the reference's file format (see
:mod:`repro_torch.ckpt.checkpoint`)."""
from repro_torch.ckpt.checkpoint import (CorruptCheckpointError,
                                         atomic_write_json, file_crc32,
                                         latest_path, latest_step,
                                         leaf_checksums, leaf_dtypes,
                                         restore, save, to_host,
                                         with_dtypes)

__all__ = ["CorruptCheckpointError", "atomic_write_json", "file_crc32",
           "latest_path", "latest_step", "leaf_checksums", "leaf_dtypes",
           "restore", "save", "to_host", "with_dtypes"]
