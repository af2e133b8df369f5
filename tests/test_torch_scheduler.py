"""The port's decode batch scheduler (``repro_torch.serving.scheduler``)
against the JAX scheduler on the CPU: the reference's ``smoke_variant``
of tinyllama-1.1b, its weights carried across by
``convert.lm_params_from_jax``, the requests of ``tests/test_serving.py``.
Greedy tokens must be equal, token for token."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models.config import smoke_variant as j_smoke_variant
from repro.models.transformer import build_model as j_build_model
from repro.serving import BatchScheduler as JScheduler
from repro.serving import Request as JRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.config import smoke_variant
from repro_torch.models.transformer import build_model
from repro_torch.serving import BatchScheduler, Request


@pytest.fixture(scope="module")
def models():
    jmodel = j_build_model(j_smoke_variant(j_get_config("tinyllama-1.1b")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke_variant(get_config("tinyllama-1.1b")))
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, params


def _run(sched, reqs):
    for r in reqs:
        sched.submit(r)
    return {r.uid: r for r in sched.run()}


def test_scheduler_matches_the_reference_token_for_token(models):
    """10 requests in waves of 4 (3 waves, the last of 2 with idle
    slots), token budgets 5–7."""
    jmodel, jparams, tmodel, params = models
    spec = [(i, [1 + i, 2, 3], 5 + (i % 3)) for i in range(10)]
    jdone = _run(JScheduler(jmodel, jparams, batch_size=4, cache_len=96),
                 [JRequest(uid=u, prompt=p, max_new_tokens=m)
                  for u, p, m in spec])
    ops.reset_launches()
    sched = BatchScheduler(tmodel, params, batch_size=4, cache_len=96,
                           device="cpu")
    done = _run(sched, [Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in spec])
    assert not any(ops.LAUNCHES.values())      # plain versions on the CPU
    assert len(done) == 10
    for u, _, m in spec:
        assert done[u].output == jdone[u].output, u
        assert len(done[u].output) == m
    rep = sched.throughput_report()
    assert rep["requests"] == 10 and rep["waves"] == 3
    assert rep["tokens"] == sum(m for _, _, m in spec)
    assert rep["tok_per_s"] > 0
    assert [s.batch for s in sched.stats] == [4, 4, 2]


def test_ragged_prompts_match_the_reference(models):
    """Prompts of 2, 5 and 3 tokens, right-aligned in one wave."""
    jmodel, jparams, tmodel, params = models
    spec = [(0, [5, 6], 4), (1, [9, 8, 7, 6, 5], 6), (2, [3, 2, 1], 3)]
    jdone = _run(JScheduler(jmodel, jparams, batch_size=3, cache_len=64),
                 [JRequest(uid=u, prompt=p, max_new_tokens=m)
                  for u, p, m in spec])
    done = _run(BatchScheduler(tmodel, params, batch_size=3, cache_len=64,
                               device="cpu"),
                [Request(uid=u, prompt=p, max_new_tokens=m)
                 for u, p, m in spec])
    assert {u: r.output for u, r in done.items()} == \
        {u: r.output for u, r in jdone.items()}


def test_eos_stops_early(models):
    _, _, tmodel, params = models
    probe = BatchScheduler(tmodel, params, batch_size=1, cache_len=64,
                           device="cpu")
    first = _run(probe, [Request(uid=0, prompt=[5, 6],
                                 max_new_tokens=4)])[0].output[0]
    sched = BatchScheduler(tmodel, params, batch_size=1, cache_len=64,
                           device="cpu")
    out = _run(sched, [Request(uid=1, prompt=[5, 6], max_new_tokens=20,
                               eos_id=first)])[1].output
    assert out == [first]


def test_per_slot_latency_and_cache_bound(models):
    """A slot done at its own step reports less than the wave's longest
    request, which reports at most the wave's wall time."""
    _, _, tmodel, params = models
    sched = BatchScheduler(tmodel, params, batch_size=2, cache_len=96,
                           device="cpu")
    done = _run(sched, [Request(uid=0, prompt=[1, 2], max_new_tokens=2),
                        Request(uid=1, prompt=[3, 4], max_new_tokens=24)])
    wave = sched.stats[0]
    assert done[0].latency_s < done[1].latency_s <= wave.wall_s + 1e-6
    assert wave.decode_steps == 24 and wave.prompt_steps == 2
    assert sched.throughput_report()["mean_latency_s"] > 0
    with pytest.raises(ValueError, match="cache"):
        _run(BatchScheduler(tmodel, params, batch_size=1, cache_len=8,
                            device="cpu"),
             [Request(uid=2, prompt=[1, 2, 3], max_new_tokens=6)])


def test_encoder_frames_raise_naming_the_roadmap(models):
    _, _, tmodel, params = models
    with pytest.raises(NotImplementedError, match="item 13"):
        BatchScheduler(tmodel, params, batch_size=1, cache_len=8,
                       frames=object(), device="cpu")
