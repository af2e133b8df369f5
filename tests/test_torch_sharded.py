"""The port's sharded round (``build_sharded_round`` on
``torch.distributed``) against the JAX package, on the CPU.

One module-scoped spawn of 8 gloo ranks (``repro_torch.compat.spawn``,
the package's rank target ``repro_torch.launch.sharded.run_cases``, so
the ranks import neither JAX nor this module) runs every case: the
allgather, ring and hier transports × the psum and tree readbacks ×
dense, blocked-CSR and ``use_gram`` rows; an f32 wire, a bf16 wire on
bf16-representable rows and bf16 rows; a NaN row; a ring message
garbled on one rank only; the four transport chaos scenarios for seeds
0, 1, 2; and the sharded fit. The tests hold each case
to ``repro.core.mapreduce_svm.mapreduce_round`` in this process on the
same numpy inputs, with the reference's own tolerances
(``tests/test_sharded_round.py``): SV ids and mask equal, α and risks
within rtol 1e-4 / atol 1e-5, SV rows within 1e-5 / 1e-6. In-process
tests hold the wire's bits, the checksum lane and the garble draw to the
reference's."""
import dataclasses
import fcntl
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import faults as jfaults
from repro import sparse as jsp
from repro.core import mapreduce_svm as jmr
from repro.data import svm_rows
from repro_torch import compat, faults
from repro_torch import sparse as tsp
from repro_torch.core import mapreduce_svm as tmr
from repro_torch.faults import chaos
from repro_torch.kernels import ops
from repro_torch.launch.sharded import Case, run_cases

NDEV = 8
CHAOS_SEEDS = (0, 1, 2)
TRANSPORTS = (("allgather", None), ("ring", None), ("hier", 2))


def _problem(n=256, d=12):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=d).astype(np.float32)
    return X, np.sign(X @ w).astype(np.float32)


def _bf16(X):
    return torch.from_numpy(X).bfloat16().float().numpy()


def _sparse(n, d, nnz, cap, seed):
    """svm_rows of the JAX package, as dense rows and the same rows
    blocked-CSR (``(indices, values, d)``, lossless: nnz < cap)."""
    Xd, y = svm_rows(n, d, seed=seed, nnz=nnz)
    Xd, y = np.asarray(Xd, np.float32), np.asarray(y, np.float32)
    sp = tsp.from_dense(torch.from_numpy(Xd), cap)
    return Xd, y, (sp.indices.numpy(), sp.values.numpy(), d)


LIN = dict(sv_capacity=32, svm=dict(C=1.0, max_epochs=10))
GRAM = dict(sv_capacity=32, svm=dict(C=1.0, max_epochs=10, use_gram=True,
                                     gram_impl="pallas"))


def _cfgs(base, **kw):
    """The same config for both packages: (torch, JAX)."""
    svm = dict(base["svm"])
    svm.update(kw.pop("svm", {}))
    top = {k: v for k, v in base.items() if k != "svm"}
    top.update(kw)
    return (T.MRSVMConfig(svm=T.SVMConfig(**svm), **top),
            J.MRSVMConfig(svm=J.SVMConfig(**svm), **top))


def _data():
    X, y = _problem()
    Xg, yg = _problem(256, 8)
    Xs_d, ys, Xs = _sparse(256, 64, 8, 16, 3)
    Xsg_d, ysg, Xsg = _sparse(256, 32, 4, 8, 5)
    Xb = _bf16(X)
    yb = np.sign(Xb @ np.random.default_rng(1).normal(size=12)
                 ).astype(np.float32)
    Xn = X.copy()
    Xn[37, 5] = np.nan
    return dict(dense=(X, y, X), gram=(Xg, yg, Xg), sparse=(Xs, ys, Xs_d),
                sparse_gram=(Xsg, ysg, Xsg_d), bf16=(Xb, yb, Xb),
                nan=(Xn, y, Xn))


def _specs():
    """name → (data key, torch cfg, JAX oracle cfg, Case kwargs)."""
    specs = {}
    for conv in ("psum", "tree"):
        for impl, hosts in TRANSPORTS:
            kw = dict(shuffle_impl=impl, converge_impl=conv,
                      hier_num_hosts=hosts, shuffle_wire_dtype="float32")
            specs[f"dense-{impl}-{conv}"] = ("dense", *_cfgs(LIN, **kw), {})
            specs[f"sparse-{impl}-{conv}"] = (
                "sparse", *_cfgs(LIN, svm=dict(row_format="sparse_csr",
                                               nnz_cap=16), **kw), {})
            specs[f"gram-{impl}-{conv}"] = ("gram", *_cfgs(GRAM, **kw), {})
    for impl, hosts in TRANSPORTS:
        kw = dict(shuffle_impl=impl, hier_num_hosts=hosts,
                  shuffle_wire_dtype="float32")
        t_cfg = _cfgs(GRAM, svm=dict(gram_impl="pallas_sparse",
                                     row_format="sparse_csr", nnz_cap=8),
                      **kw)[0]
        j_cfg = _cfgs(GRAM, svm=dict(gram_impl="xla"), **kw)[1]
        specs[f"sparse_gram-{impl}"] = ("sparse_gram", t_cfg, j_cfg, {})
        # the production wire: bf16 on bf16-representable f32 rows
        specs[f"bf16wire-{impl}"] = (
            "bf16", *_cfgs(LIN, shuffle_impl=impl, hier_num_hosts=hosts),
            dict(sv_dtype="bfloat16") if impl != "allgather" else {})
        # bf16 rows and a bf16 wire, as the svm-tfidf config runs
        specs[f"bf16rows-{impl}"] = (
            "bf16", *_cfgs(LIN, shuffle_impl=impl, hier_num_hosts=hosts),
            dict(dtype="bfloat16"))
        specs[f"nan-{impl}"] = (
            "nan", *_cfgs(LIN, shuffle_impl=impl, hier_num_hosts=hosts,
                          shuffle_wire_dtype="float32",
                          converge_impl="tree" if impl == "hier"
                          else "psum"), dict(rounds=1))
    # one rank's received ring message garbled at round 0: the integrity
    # lane's flag must reach every rank, not only those that saw it
    for victim, seed in ((3, 0), (6, 1)):
        specs[f"garble-ring-r{victim}"] = (
            "dense", *_cfgs(LIN, shuffle_impl="ring",
                            shuffle_wire_dtype="float32",
                            shuffle_wire_check=True),
            dict(rounds=1, garble=(victim, seed)))
    # hier_num_hosts None: the hosts of the group, counted by host name
    # when the round is built (one here: a single grouped all-gather)
    specs["onehost-hier"] = ("dense", *_cfgs(LIN, shuffle_impl="hier",
                                             shuffle_wire_dtype="float32"),
                             {})
    for impl in ("allgather", "ring"):
        specs[f"zero_one-{impl}"] = (
            "dense", *_cfgs(LIN, shuffle_impl=impl, risk_loss="zero_one",
                            shuffle_wire_dtype="float32"), {})
    return specs


SPECS = _specs()
NAMES = list(SPECS)


@pytest.fixture(scope="module")
def data():
    return _data()


def _fit_args(data):
    """The sharded fit's (X, y, cfg): dense rows over the checked ring;
    eq. 8 fires at round 3 of at most 6."""
    X, y, _ = data["dense"]
    cfg = T.MRSVMConfig(sv_capacity=32, max_rounds=6, gamma=0.015,
                        shuffle_impl="ring", shuffle_wire_dtype="float32",
                        shuffle_wire_check=True,
                        svm=T.SVMConfig(C=1.0, max_epochs=10))
    return X, y, cfg


@pytest.fixture(scope="module")
def runs(data):
    """Every case and the transport chaos scenarios on 8 gloo ranks, one
    spawn. → per rank the results of ``run_cases``."""
    cases = []
    for name, (key, t_cfg, _, kw) in SPECS.items():
        X, y, _ = data[key]
        cases.append(Case(name, t_cfg, X, y, **kw))
    t0 = time.monotonic()
    out = compat.spawn(run_cases, NDEV, (cases, CHAOS_SEEDS, _fit_args(data)),
                       device="cpu", timeout_s=120.0, join_timeout_s=300.0)
    assert time.monotonic() - t0 < 300.0
    return out


def _case(runs, name, rank=0):
    return runs[rank]["cases"][NAMES.index(name)]


def _dense_x(x):
    if isinstance(x, tuple):
        idx, vals, d = x
        out = np.zeros((idx.shape[0], d), np.float32)
        np.add.at(out, (np.arange(idx.shape[0])[:, None], idx),
                  vals.astype(np.float32))
        return out
    return np.asarray(x, np.float32)


_ORACLE = {}


def _oracle(data, name):
    """The JAX package's functional rounds on the same numpy rows (dense
    rows for the blocked-CSR cases, as the reference's sharded tests
    hold them): per round (risks, ids, mask, alpha, x)."""
    key, _, j_cfg, kw = SPECS[name]
    # the transport fields do not enter the functional round
    jk = (key, dataclasses.replace(j_cfg, shuffle_impl="allgather",
                                   converge_impl="psum", hier_num_hosts=None,
                                   shuffle_wire_dtype="float32"),
          kw.get("rounds", 3), kw.get("dtype", "float32"))
    if jk not in _ORACLE:
        _, y, Xd = data[key]
        n, d = Xd.shape
        per = n // NDEV
        dt = jnp.dtype(jk[3])        # the rows' dtype, labels and mask too
        Xp = jnp.asarray(Xd, dt).reshape(NDEV, per, d)
        yp = jnp.asarray(y, dt).reshape(NDEV, per)
        mp = jnp.ones((NDEV, per), dt)
        sv = jmr.init_sv_buffer(j_cfg.sv_capacity, d, dt)
        rounds = []
        for _ in range(jk[2]):
            out = jmr.mapreduce_round(Xp, yp, mp, sv, jk[1])
            sv = out.sv
            rounds.append(tuple(np.asarray(a, np.float32) for a in (
                out.risks, sv.ids, sv.mask, sv.alpha, sv.x)))
        _ORACLE[jk] = rounds
    return _ORACLE[jk]


def _same_on_every_rank(runs, name):
    ref = _case(runs, name)
    for r in range(1, NDEV):
        got = _case(runs, name, r)
        for k in ref:
            for a, b in zip(ref[k], got[k]):
                for u, v in zip(a if isinstance(a, tuple) else (a,),
                                b if isinstance(b, tuple) else (b,)):
                    np.testing.assert_array_equal(u, v, err_msg=f"{k} r{r}")


REFERENCE_CASES = [n for n in NAMES if not n.startswith(("nan", "garble"))]


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_sharded_round_matches_the_reference(runs, data, name):
    """Each rank's outputs are the same, and over 3 rounds they hold to
    the JAX functional round on the same rows (bf16 rows too): SV ids
    and mask equal, α and risks within 1e-4 / 1e-5, SV rows within
    1e-5 / 1e-6; w and b of the best reducer."""
    _same_on_every_rank(runs, name)
    got = _case(runs, name)
    want = _oracle(data, name)
    for t, (risks, ids, mask, alpha, x) in enumerate(want):
        np.testing.assert_allclose(got["risks"][t], risks, rtol=1e-4,
                                   atol=1e-5, err_msg=f"round {t}")
        np.testing.assert_array_equal(got["ids"][t], ids)
        np.testing.assert_array_equal(got["mask"][t], mask)
        np.testing.assert_allclose(got["alpha"][t], alpha, rtol=1e-4,
                                   atol=1e-5)
        if not SPECS[name][1].svm.use_gram:
            np.testing.assert_allclose(_dense_x(got["x"][t]), x, rtol=1e-5,
                                       atol=1e-6)
    d = data[SPECS[name][0]][2].shape[1]
    assert got["w"][-1].shape == (d,) and np.shape(got["b"][-1]) == ()
    if name.startswith("sparse-"):
        assert isinstance(got["x"][-1], tuple) and \
            got["x"][-1][0].shape[1] == 16      # stays blocked-CSR


def _allgather_of(name):
    if name == "onehost-hier":
        return "dense-allgather-psum"
    parts = name.split("-")
    return "-".join([parts[0], "allgather"] + parts[2:])


PACKED = [n for n in NAMES if n.split("-")[1] in ("ring", "hier")
          and not n.startswith(("nan", "zero_one", "garble"))]


@pytest.mark.parametrize("name", PACKED)
def test_packed_transport_equals_allgather(runs, name):
    """With the wire dtype equal to the rows' (or the rows
    representable in it) ring and hier give allgather's SV buffer and
    hypothesis bit for bit. The risks agree to 1e-6: on the CPU the
    plain ``hinge_scores`` sums a hypothesis's column in an order that
    depends on how many hypotheses share the call (ring scores one a
    stage, hier four, allgather eight)."""
    got, want = _case(runs, name), _case(runs, _allgather_of(name))
    for k in ("ids", "mask", "alpha", "y", "x", "w", "b"):
        for t, (a, b) in enumerate(zip(got[k], want[k])):
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(u, v, err_msg=f"{k} t{t}")
    for a, b in zip(got["risks"], want["risks"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", [n for n in NAMES if n.endswith("-tree")])
def test_tree_readback_equals_psum(runs, name):
    """converge_impl="tree" ≡ "psum" on every transport: the same SV
    buffer and hypothesis bit for bit; risks to 1e-6 (the summation
    order differs), as the reference's check."""
    got = _case(runs, name)
    want = _case(runs, name[:-len("tree")] + "psum")
    for k in ("ids", "x", "alpha", "w"):
        for a, b in zip(got[k], want[k]):
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(u, v)
    for a, b in zip(got["risks"], want["risks"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", [t[0] for t in TRANSPORTS])
def test_bf16_rows_equal_the_ports_functional_round(runs, data, impl):
    """bf16 rows over a bf16 wire (the svm-tfidf setting): SV ids, α and
    rows bit for bit with the port's functional round on the same rows
    (each rank's 1-job solve is the same per-job arithmetic), risks
    within 1e-5 relative (the partial sums add in another order)."""
    X, y, _ = data["bf16"]
    cfg = SPECS[f"bf16rows-{impl}"][1]
    Xp = torch.from_numpy(X).bfloat16().reshape(NDEV, -1, X.shape[1])
    yp = torch.from_numpy(y).bfloat16().reshape(NDEV, -1)
    mp = torch.ones_like(yp)
    sv = T.init_sv_buffer(cfg.sv_capacity, X.shape[1], torch.bfloat16, "cpu")
    got = _case(runs, f"bf16rows-{impl}")
    for t in range(3):
        out = T.mapreduce_round(Xp, yp, mp, sv, cfg)
        sv = out.sv
        np.testing.assert_array_equal(got["ids"][t], sv.ids.numpy())
        np.testing.assert_array_equal(got["alpha"][t], sv.alpha.numpy())
        np.testing.assert_array_equal(got["x"][t], sv.x.float().numpy())
        np.testing.assert_allclose(got["risks"][t], out.risks.numpy(),
                                   rtol=1e-5, atol=0)


def test_reference_packed_round_departs_from_its_allgather_on_bf16_rows():
    """Why the port's sharded round keeps α in f32 on bf16 rows: the JAX
    package's own sharded round (one device here) disagrees with itself
    there. Its packed ring casts the buffer's α to the rows' dtype, so
    it is allgather's α rounded to bf16, beyond the 1e-4 / 1e-5 its
    tests allow; and from round 1 its fold rounds the carried α to bf16,
    so its allgather leaves the functional round. The port's sharded
    round holds to the functional round on every transport
    (``test_sharded_round_matches_the_reference``)."""
    import jax
    from jax.sharding import Mesh
    X, y, _ = _data()["bf16"]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    Xb, yb = jnp.asarray(X, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    mb = jnp.ones_like(yb)
    alpha = {}
    for impl in ("allgather", "ring"):
        j_cfg = _cfgs(LIN, shuffle_impl=impl)[1]       # the bf16 wire
        fn = jmr.build_sharded_round(mesh, ("data",), j_cfg, X.shape[0])
        sv = jmr.init_sv_buffer(j_cfg.sv_capacity, X.shape[1], jnp.bfloat16)
        alpha[impl] = []
        for _ in range(2):
            sv, _, _, _ = fn(Xb, yb, mb, sv)
            alpha[impl].append(sv.alpha)
    sv = jmr.init_sv_buffer(32, X.shape[1], jnp.bfloat16)
    for t in range(2):
        sv = jmr.mapreduce_round(Xb[None], yb[None], mb[None], sv,
                                 _cfgs(LIN)[1]).sv
        ag, ring = alpha["allgather"][t], alpha["ring"][t]
        assert ring.dtype == jnp.bfloat16 and ag.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(ring, np.float32),
                                      np.asarray(ag.astype(jnp.bfloat16),
                                                 np.float32))
        assert not np.allclose(np.asarray(ring, np.float32), np.asarray(ag),
                               rtol=1e-4, atol=1e-5)
        assert np.allclose(np.asarray(ag), np.asarray(sv.alpha), rtol=1e-4,
                           atol=1e-5) == (t == 0), f"round {t}"


@pytest.mark.parametrize("impl", [t[0] for t in TRANSPORTS])
def test_nan_row_gives_nonfinite_risks_on_every_rank(runs, data, impl):
    """A NaN feature gives non-finite risks at round 0 on every rank, as
    the JAX package's functional round does (so the eq. 8 readback
    raises FaultDetected("core") everywhere): gloo's MAX and the
    argmin must not drop it."""
    want = _oracle(data, f"nan-{impl}")[0][0]
    assert not np.isfinite(want).all()
    for r in range(NDEV):
        risks = _case(runs, f"nan-{impl}", r)["risks"][0]
        assert not np.isfinite(risks).all(), f"rank {r}: {risks}"
        with pytest.raises(faults.FaultDetected) as e:
            faults.check_finite_risks(risks, where="sharded round 0")
        assert e.value.layer == "core"


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n.startswith("garble")])
def test_one_ranks_garbled_message_is_detected_on_every_rank(runs, name):
    """A message garbled on its way to one rank only (the rank it came
    from kept its clean copy): every rank's risks are +inf, so every
    rank's eq. 8 readback raises FaultDetected("transport") and none
    goes on to the next round's collectives alone."""
    for r in range(NDEV):
        risks = _case(runs, name, r)["risks"][0]
        assert np.isposinf(risks).all(), f"rank {r}: {risks}"
        with pytest.raises(faults.FaultDetected) as e:
            faults.check_finite_risks(risks, where="sharded round 0")
        assert e.value.layer == "transport"


def test_sharded_fit_follows_the_functional_fit(runs, data):
    """``fit_sharded`` (the functional fit's driver over the sharded
    round) stops at the round ``fit_mapreduce`` stops at, with the same
    picks and |SV| each round, risks within 1e-5 relative and the same
    best hypothesis, on every rank."""
    X, y, cfg = _fit_args(data)
    want = T.fit_mapreduce(X, y, NDEV, cfg, device="cpu")
    for r in range(NDEV):
        got = runs[r]["fit"]
        assert len(got["history"]) == want.rounds < cfg.max_rounds
        for g, h in zip(got["history"], want.history):
            assert (g["reducer"], g["sv_count"]) == (h["reducer"],
                                                     h["sv_count"])
            np.testing.assert_allclose(g["risk"], h["risk"], rtol=1e-5)
        np.testing.assert_array_equal(got["w"], want.w.numpy())
        assert got["b"] == float(want.b)


def test_spawn_chooses_the_backend(runs, monkeypatch):
    """gloo for CPU ranks and for ranks sharing a card, NCCL when each
    rank has a card of its own; the spawned ranks record theirs."""
    assert {r["backend"] for r in runs} == {"gloo"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert compat.choose_backend(8, "cpu") == "gloo"
    assert compat.choose_backend(1, "cuda") == "nccl"
    assert compat.choose_backend(8, "cuda") == "gloo"


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("name", chaos.TRANSPORT)
def test_transport_chaos_scenario_meets_the_reference_outcome(runs, name,
                                                              seed):
    """wire_check_clean and hier_transient survive bit for bit,
    ring_garble and hier_garble are detected as transport faults, on
    every one of the 8 ranks."""
    i = CHAOS_SEEDS.index(seed) * len(chaos.TRANSPORT) \
        + chaos.TRANSPORT.index(name)
    expect = dict((n, e) for n, e, _ in chaos.SCENARIOS)[name]
    for r in range(NDEV):
        outcome, ok, detail = runs[r]["chaos"][i]
        assert ok and outcome == expect, f"rank {r}: {outcome}: {detail}"


def test_collectives_follow_lax_semantics(runs):
    """ppermute gives zeros to a rank that receives nothing and copies a
    self pair; pmax passes NaN; all_gather (bf16 by its bits, tiled),
    the grouped all_gather, ring_shift and psum on 8 gloo ranks."""
    for r in range(NDEV):
        p = runs[r]["probe"]
        x = lambda i: np.arange(3, dtype=np.float32) + 10 * i  # noqa: E731
        assert p["index"] == r and p["size"] == NDEV
        np.testing.assert_array_equal(p["psum"], sum(x(i) for i in
                                                     range(NDEV)))
        assert p["pmax"][0] == NDEV - 1 and np.isnan(p["pmax"][1])
        np.testing.assert_array_equal(
            p["gather"], np.repeat(np.arange(NDEV)[:, None] + 0.5, 2, 1))
        np.testing.assert_array_equal(
            p["tiled"], np.concatenate([x(i) for i in range(NDEV)]))
        g0 = range(NDEV // 2) if r < NDEV // 2 else range(NDEV // 2, NDEV)
        np.testing.assert_array_equal(p["groups"], np.stack([x(i)
                                                             for i in g0]))
        want = x(0) if r == 1 else x(r) if r == NDEV - 1 else 0 * x(0)
        np.testing.assert_array_equal(p["ppermute"], want)
        np.testing.assert_array_equal(p["ring"], x((r - 1) % NDEV))


def test_topology_checks_match_the_reference():
    """Tree needs a power-of-two rank count and hier a host count that
    divides the ranks, refused at build time with the reference's
    errors; a pinned host count needs no collective."""
    for kw, n in ((dict(converge_impl="tree"), 6),
                  (dict(shuffle_impl="hier", hier_num_hosts=3), 8)):
        t_cfg, j_cfg = _cfgs(LIN, **kw)
        with pytest.raises(ValueError) as te:
            tmr.resolve_topology(t_cfg, n)
        with pytest.raises(ValueError) as je:
            jmr.resolve_topology(j_cfg, n)
        assert str(te.value) == str(je.value)
    t_cfg, j_cfg = _cfgs(LIN, shuffle_impl="hier", hier_num_hosts=2)
    assert tmr.resolve_topology(t_cfg, 8) == jmr.resolve_topology(j_cfg, 8)
    assert tmr.resolve_topology(_cfgs(LIN)[0], 6) == 1


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_records_the_same_valid_schedule(runs, name):
    """Each case's collectives as every rank recorded them
    (``compat.record_collectives``; ``run_cases`` checked each valid):
    the same ordered schedule on all 8 ranks, a collective a round at
    least."""
    from repro_torch import analysis
    i = NAMES.index(name)
    sched = {f"rank{r}": res["schedules"][i] for r, res in enumerate(runs)}
    analysis.assert_schedules_agree(sched, program=name)
    assert len(sched["rank0"]) >= len(_case(runs, name)["risks"])


def test_ranks_import_neither_jax_nor_the_reference(runs):
    assert all(r["modules"] == [] for r in runs)
    # every case ran the plain versions here: no kernel launched
    assert not any(v for r in runs for v in r["routes"].values())


# ---------------------------------------------------------------------------
# in process: the wire's bits, the checksum lane, the garble draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt,d", [("dense", 12), ("dense", 13),
                                   ("sparse", 40)])
def test_wire_rows_equal_the_reference_bits(wire, fmt, d):
    """``pack_wire_rows`` gives the reference's lanes bit for bit (bf16
    pairs, an odd width padded, int32 ids by their bits) and
    ``unpack_wire_rows`` inverts it."""
    rng = np.random.default_rng(d)
    X = rng.normal(size=(5, d)).astype(np.float32)
    X[X < 0.3] = 0.0
    if fmt == "sparse":
        xt = tsp.from_dense(torch.from_numpy(X), 7)
        xj = jsp.from_dense(jnp.asarray(X), 7)
    else:
        xt, xj = torch.from_numpy(X), jnp.asarray(X)
    ft, st = T.pack_wire_rows(xt, wire)
    fj, sj = jmr.pack_wire_rows(xj, jnp.dtype(wire))
    assert st == sj
    np.testing.assert_array_equal(ft.view(torch.int32).numpy(),
                                  np.asarray(fj).view(np.int32))
    back = T.unpack_wire_rows(ft, 5, d, wire, st,
                              nnz_cap=7 if fmt == "sparse" else None)
    want = jmr.unpack_wire_rows(fj, 5, d, jnp.dtype(wire), sj,
                                nnz_cap=7 if fmt == "sparse" else None)
    if fmt == "sparse":
        np.testing.assert_array_equal(back.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(back.values.float().numpy(),
                                      np.asarray(want.values, np.float32))
        assert not back.ids_in_range          # new rows: checked first
    else:
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_checksum_lane_equals_the_reference(seed):
    """The integrity lane: the int32 wrap-sum of the message's bits
    (large lanes make the sum wrap), as the reference's
    ``jnp.sum(bitcast(side, int32))`` gives it."""
    import jax
    rng = np.random.default_rng(seed)
    side = rng.normal(size=4099).astype(np.float32) * 1e30
    side[::7] = rng.normal(size=side[::7].shape) * 1e-30
    got = tmr._wire_sum(torch.from_numpy(side)).item()
    want = int(jnp.sum(jax.lax.bitcast_convert_type(jnp.asarray(side),
                                                    jnp.int32)))
    assert got == want
    assert abs(int(side.view(np.int32).astype(np.int64).sum())) > 2 ** 31


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("hop", [0, 1, 3])
def test_garble_draw_equals_the_reference(seed, hop):
    """``garble_wire`` flips the lane and mantissa bit that the same plan
    draws in the reference, and nothing else; off-hop and unarmed it
    passes the message through untouched."""
    msg = np.random.default_rng(seed).normal(size=301).astype(np.float32)
    spec = (faults.FaultSpec("ring_garble", when=hop, count=1,
                             param=seed * 17),)
    jspec = (jfaults.FaultSpec("ring_garble", when=hop, count=1,
                               param=seed * 17),)
    t_msg = torch.from_numpy(msg.copy())
    assert faults.garble_wire(t_msg, hop) is t_msg
    with faults.inject(faults.FaultPlan(seed, spec)) as armed:
        assert faults.garble_wire(t_msg, hop + 1) is t_msg
        got = faults.garble_wire(t_msg, hop).numpy()
    assert armed.fired
    with jfaults.inject(jfaults.FaultPlan(seed, jspec)):
        want = np.asarray(jfaults.garble_wire(jnp.asarray(msg), hop))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got.view(np.int32) != msg.view(np.int32)).sum() == 1
    np.testing.assert_array_equal(t_msg.numpy(), msg)   # input untouched


def test_garbled_ids_never_reach_a_kernel():
    """A garbled index lane can name a column ≥ d. Unpacked rows carry no
    checked mark, so the solve and the scoring refuse them before any
    launch (on the CPU the same check runs before the plain version)."""
    d = 40
    X = tsp.from_dense(torch.eye(6, d), 4)
    flat, ws = T.pack_wire_rows(X, "float32")
    bits = flat.view(torch.int32)
    bits[ws - 4] = d + 5                       # row 0's first id lane
    bad = T.unpack_wire_rows(flat, 6, d, "float32", ws, nnz_cap=4)
    assert int(bad.indices.max()) == d + 5 and not bad.ids_in_range
    y = torch.ones(1, 12)
    with pytest.raises(ValueError, match="column ids outside"):
        ops.cd_solve(X.reshape(1, 6, d), bad, y, torch.ones(1, 12), C=1.0,
                     tol=1e-3, max_epochs=2)
    with pytest.raises(ValueError, match="column ids outside"):
        ops.hinge_scores(bad, torch.ones(2, d), torch.zeros(2),
                         torch.ones(6), torch.ones(6))


# ---------------------------------------------------------------------------
# the spawn helper, the entry points' device rule, the row shards, the
# build lock
# ---------------------------------------------------------------------------

def test_mismatched_collective_fails_within_the_spawn_limit():
    """A rank that never joins its partners' all-reduce: the others fail
    (their collective times out or sees the peer leave) and the spawn
    raises, well inside its join limit; no rank outlives it."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        compat.spawn(compat.rank_sum, 3, (1,), device="cpu", timeout_s=5.0,
                     join_timeout_s=40.0)
    assert time.monotonic() - t0 < 40.0
    assert compat.spawn(compat.rank_sum, 3, (), device="cpu") == [3.0] * 3


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.MRSVMConfig(sv_capacity=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_sharded_round(cfg, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compat.spawn(compat.rank_sum, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos.Ctx().run_transport([0])


@pytest.mark.parametrize("count", [1, 3, 8])
def test_row_shards_union_is_one_calls_rows(count):
    """``svm_rows_device`` / ``svm_rows_sparse_device`` with
    process_index / process_count make only their stateless blocks; the
    shards in order are one call's rows and labels bit for bit."""
    from repro_torch.data.pipeline import (svm_rows_device,
                                           svm_rows_sparse_device)
    n = 2500                                # blocks of 1024, ragged ends
    X, y = svm_rows_device(n, 64, seed=4, dtype=torch.float32, device="cpu")
    parts = [svm_rows_device(n, 64, seed=4, dtype=torch.float32,
                             device="cpu", process_index=i,
                             process_count=count) for i in range(count)]
    assert torch.equal(torch.cat([p[0] for p in parts]), X)
    assert torch.equal(torch.cat([p[1] for p in parts]), y)
    S, ys = svm_rows_sparse_device(n, 256, 8, seed=4, device="cpu")
    parts = [svm_rows_sparse_device(n, 256, 8, seed=4, device="cpu",
                                    process_index=i, process_count=count)
             for i in range(count)]
    assert torch.equal(torch.cat([p[0].indices for p in parts]), S.indices)
    assert torch.equal(torch.cat([p[0].values for p in parts]), S.values)
    assert torch.equal(torch.cat([p[1] for p in parts]), ys)


def test_kernel_build_holds_a_file_lock(tmp_path, monkeypatch):
    """A build holds an exclusive lock on the build directory's lock
    file, so ranks that reach a stale source together build it once."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path",
                        lambda name: tmp_path / f"lib{name}.so")
    held = []

    def stale():
        with open(tmp_path / ".lock") as other:
            try:
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
                held.append(False)
            except BlockingIOError:
                held.append(True)
        return 0.0
    monkeypatch.setattr(build, "_build_stale", stale)
    build.build_all()
    assert held == [True]


def test_new_modules_and_the_example_import_neither_jax_nor_the_reference():
    """The AST test of ``test_torch_kernels.py`` walks every module of
    the package and ``examples/torch_*.py``; the sharded mode's files
    are among them and clean."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    files = [root / "src/repro_torch" / f for f in (
        "compat.py", "launch/sharded.py", "core/mapreduce_svm.py",
        "faults/chaos.py", "sparse.py")] + \
        [root / "examples/torch_distributed_svm.py"]
    for f in files:
        tree = ast.parse(f.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + \
            [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in mods if m.split(".")[0] in
                    ("jax", "jaxlib", "repro")], f
        assert f in set((root / "src/repro_torch").rglob("*.py")) | set(
            (root / "examples").glob("torch_*.py"))
