"""Serving: the streaming polarization service and the decode batch
scheduler."""
from repro_torch.serving.scheduler import BatchScheduler, Request, WaveStats
from repro_torch.serving.svm_stream import (MicroBatch, ModelSnapshot,
                                            StreamingSVMService,
                                            StreamWaveStats)

__all__ = ["BatchScheduler", "Request", "WaveStats", "MicroBatch",
           "ModelSnapshot", "StreamingSVMService", "StreamWaveStats"]
