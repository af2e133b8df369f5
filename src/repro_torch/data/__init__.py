"""Deterministic synthetic data for the MapReduce SVM."""
from repro_torch.data.pipeline import (default_row_nnz, host_row_range,
                                       svm_rows, svm_rows_device,
                                       svm_rows_shard, svm_rows_sparse,
                                       svm_rows_sparse_device)

__all__ = ["default_row_nnz", "host_row_range", "svm_rows",
           "svm_rows_device", "svm_rows_shard", "svm_rows_sparse",
           "svm_rows_sparse_device"]
