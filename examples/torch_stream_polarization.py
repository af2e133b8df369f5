"""Streaming polarization over drifting monthly corpora on the PyTorch
port: the paper's §SONUÇ future work served live.

Two tenant streams of Twitter-style messages drift month over month.
Each month's vectorized micro-batches queue in the
:class:`~repro_torch.serving.StreamingSVMService`; its background wave
scheduler folds them into each stream's SV_global (new rows ∪ carried
SVs only: the old corpus never travels) while predictions keep serving
from the current snapshot. Compare the stale model's accuracy on the new
month against the folded model's.

    PYTHONPATH=src python examples/torch_stream_polarization.py   # cuda
    PYTHONPATH=src python examples/torch_stream_polarization.py --device cpu
"""
import argparse

import torch

from repro_torch.core import MRSVMConfig, SVMConfig, fit_mapreduce
from repro_torch.serving import StreamingSVMService
from repro_torch.text import (CorpusConfig, fit_transform, generate,
                              transform, vectorize)


def month_corpus(seed: int, n: int, device):
    c = generate(CorpusConfig(num_messages=n, classes=(-1, 1), seed=seed))
    return c.texts, torch.tensor(c.labels, dtype=torch.float32,
                                 device=device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = MRSVMConfig(sv_capacity=256, gamma=1e-4, max_rounds=4,
                      svm=SVMConfig(C=1.0, max_epochs=15))
    svc = StreamingSVMService(cfg, num_partitions=8, max_batches_per_wave=4,
                              keep_history=True, device=args.device)
    dev = svc.device

    print(f"month 0: train each stream on its initial corpus ({dev})")
    idfs = {}
    for tenant, seed in (("politics", 0), ("sports", 1)):
        texts, y0 = month_corpus(seed, 1200, dev)
        X0, idf = fit_transform(vectorize(texts, 4096), device=dev)
        idfs[tenant] = idf
        model = fit_mapreduce(X0, y0, 8, cfg)
        svc.register(tenant, model)
        acc = float((svc.predict(tenant, X0) == y0).float().mean())
        print(f"  {tenant}: acc={acc:.3f} |SV|={int(model.sv.mask.sum())}")

    svc.start()           # background wave scheduler: folds run off-line
    for month in (1, 2):
        batches = {}
        for tenant, seed in (("politics", 0), ("sports", 1)):
            texts, ym = month_corpus(100 * month + seed, 800, dev)
            Xm = transform(vectorize(texts, 4096), idfs[tenant], device=dev)
            batches[tenant] = (Xm, ym)
            stale = float((svc.predict(tenant, Xm) == ym).float().mean())
            # split the month into micro-batches: they queue per stream
            for lo in range(0, Xm.shape[0], 400):
                svc.submit(tenant, Xm[lo:lo + 400], ym[lo:lo + 400])
            print(f"month {month} {tenant}: stale acc={stale:.3f} "
                  f"(queued {Xm.shape[0]} rows)")
        if not svc.wait_idle(timeout_s=300):
            raise RuntimeError(f"month {month} batches never folded")
        for tenant, (Xm, ym) in batches.items():
            fresh = float((svc.predict(tenant, Xm) == ym).float().mean())
            snap = svc.snapshot(tenant)
            print(f"month {month} {tenant}: folded acc={fresh:.3f} "
                  f"(model v{snap.version}, "
                  f"|SV|={int(snap.model.sv.mask.sum())})")
    svc.stop()
    print(svc.throughput_report())


if __name__ == "__main__":
    main()
