"""Deterministic synthetic data: LM token batches and the MapReduce
SVM's rows."""
from repro_torch.data.pipeline import (DataConfig, default_row_nnz,
                                       host_row_range, lm_batch_at,
                                       lm_batches, svm_rows, svm_rows_device,
                                       svm_rows_shard, svm_rows_sparse,
                                       svm_rows_sparse_device)

__all__ = ["DataConfig", "default_row_nnz", "host_row_range", "lm_batch_at",
           "lm_batches", "svm_rows", "svm_rows_device", "svm_rows_shard",
           "svm_rows_sparse", "svm_rows_sparse_device"]
