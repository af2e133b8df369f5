"""svm-tfidf — the paper's own workload: MapReduce SVM on a TF×IDF
matrix (Çatak 2014), with the same defaults as the reference config."""
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SVMTfidfConfig:
    name: str = "svm-tfidf"
    family: str = "svm"
    num_features: int = 131072       # hashed TF×IDF space (2^17)
    sv_capacity: int = 2048
    rows_per_device: int = 8192      # training rows per partition
    C: float = 1.0
    max_epochs: int = 10
    stream_rows_per_wave: int = 8192  # new message rows folded per serve wave
    dtype: str = "bfloat16"   # bf16 feature stream, f32 solver state
    shuffle_impl: str = "ring"  # SV merge transport of the sharded mode
    row_format: str = "dense"   # 'dense' | 'sparse_csr'
    nnz_cap: int = 256          # sparse_csr: (index, value) slots per row
    row_nnz: Optional[int] = None  # synthetic generator nonzeros/row;
    #                                None = the d/256 density default
    citation: str = "Çatak 2014 (the reproduced paper)"

    def __post_init__(self):
        from repro_torch.core.mapreduce_svm import SHUFFLE_IMPLS
        if self.shuffle_impl not in SHUFFLE_IMPLS:
            raise ValueError(
                f"shuffle_impl must be one of {SHUFFLE_IMPLS}, "
                f"got {self.shuffle_impl!r}")


CONFIG = SVMTfidfConfig()
