"""Step builders, ported from ``repro/launch/steps.py``: the training,
prefill and decode steps of every LM family (dense, MoE, VLM, the
attention-free ssm, the hybrid and the encoder-decoder), with their
abstract inputs as ``meta`` tensors.

Input-shape suite (the reference's):
    train_4k     seq=4096    global_batch=256   (training)
    prefill_32k  seq=32768   global_batch=32    (inference-prefill)
    decode_32k   seq=32768   global_batch=128   (decode: 1 token, KV=seq)
    long_500k    seq=524288  global_batch=1     (long-context decode)

A step runs on whatever device its tensors are on. The serve step also
runs on a mesh of ranks (:func:`build_serve_step` with a
``launch.mesh.Mesh``; dense and VLM decoders): each rank then holds the
shards that the bundle's ``in_shardings`` place on it, as the
reference's ``build_serve_step(cfg, mesh)`` under SPMD. The train and
prefill steps are for one process: ``mesh`` and ``rules`` must be
``None`` (their sharded forms are ROADMAP Queue 1 item 13g-c), and
their ``in_shardings`` and ``out_shardings`` are ``None``. The train
step updates the params and the optimizer state in place, the serve
step the caches: ``donate_argnums`` names them, as the reference's.

The paper's own workload, svm-tfidf, as steps on a mesh
(:func:`build_svm_round_step`, :func:`build_svm_sweep_step`,
:func:`build_svm_serve_step`): the sharded round, sweep round and
streaming wave over the mesh's batch axes, the reference's
``shard_map`` programs as the per-rank bodies of ``core.mapreduce_svm``
and ``core.sweep``. :func:`per_host_abstract` gives the inputs each of
N processes makes; :func:`local_abstract` a rank's own shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch import sparse as sparse_rows
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (lm_logits, tree_leaves,
                                       tree_unflatten, tree_map)
from repro_torch.models.transformer import build_model


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def applicability(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if the (arch, shape) pair runs; else a skip reason."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.attn_free or cfg.family == "hybrid"
                         or cfg.sliding_window is not None)
        if cfg.is_encoder_decoder:
            return ("SKIP: encoder-decoder with architecturally capped "
                    "decoder context (448) — long_500k out of family range")
        if not sub_quadratic:
            return ("SKIP: pure full-attention arch — long_500k requires "
                    "sub-quadratic attention (no SWA variant in model card)")
    return None


def _single_process(mesh, rules) -> None:
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "sharded train and prefill steps (mesh=, rules=) are not "
            "ported to repro_torch yet (ROADMAP Queue 1 item 13g-c); pass "
            "mesh=None")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: ModelConfig, shape: InputShape):
    """The train batch of ``shape`` as ``meta`` tensors."""
    B, S = shape.global_batch, shape.seq_len
    i32 = lambda s: _meta(s, torch.int32)
    if cfg.is_encoder_decoder:
        S_dec = min(S, cfg.max_decoder_len)
        return {"frames": _meta((B, cfg.encoder_seq, cfg.d_model),
                                cfg.torch_dtype),
                "tokens": i32((B, S_dec)), "labels": i32((B, S_dec))}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        return {"prefix_embeds": _meta((B, P, cfg.d_model), cfg.torch_dtype),
                "tokens": i32((B, S - P)), "labels": i32((B, S - P))}
    return {"tokens": i32((B, S)), "labels": i32((B, S))}


class StepBundle(NamedTuple):
    fn: Callable
    args: Tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    model: Any


def build_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                     opt_cfg: Optional[optim.OptConfig] = None,
                     rules: Optional[dict] = None,
                     remat: bool = True) -> StepBundle:
    """→ ``train_step(params, opt_state, batch)`` returning ``(params,
    opt_state, {"loss", "ce", "aux", "lr", "grad_norm"})``: the loss and
    its gradients by autograd (each layer checkpointed when ``remat``),
    then one AdamW step written into ``params`` and ``opt_state`` in
    place. The metrics are 0-d tensors on the device: nothing in the step
    waits for it."""
    _single_process(mesh, rules)
    if remat and not cfg.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = build_model(cfg)
    opt_cfg = opt_cfg or optim.OptConfig()

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            # aliases of the params' storage that autograd may track
            wrt = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = model.loss(wrt, batch)
            grads = torch.autograd.grad(loss, tree_leaves(wrt))
        params, opt_state, om = optim.apply_updates(
            params, tree_unflatten(params, grads), opt_state, opt_cfg)
        return params, opt_state, {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}

    params_abs = model.abstract()
    return StepBundle(
        fn=train_step,
        args=(params_abs, optim.abstract_state(params_abs),
              train_batch_abstract(cfg, shape)),
        in_shardings=None, out_shardings=None,
        donate_argnums=(0, 1), model=model)


def build_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                       rules: Optional[dict] = None) -> StepBundle:
    """→ ``prefill_step(params, batch)``: the full-context forward, then
    the last position's logits (B, 1, V) only (the production prefill
    result; full logits would be B·S·V)."""
    _single_process(mesh, rules)
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            enc = model.encode(params, batch["frames"])
            h, _ = model.hidden_states(params, batch["tokens"], enc)
        else:
            h, _ = model.hidden_states(params, batch["tokens"],
                                       batch.get("prefix_embeds"))
        return lm_logits(params["embed"], h[:, -1:, :], cfg.tie_embeddings)

    batch_abs = train_batch_abstract(cfg, shape)
    batch_abs.pop("labels")
    return StepBundle(
        fn=prefill_step, args=(model.abstract(), batch_abs),
        in_shardings=None, out_shardings=None, donate_argnums=(),
        model=model)


def make_serve_step(model) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """→ ``serve_step(params, state, tokens (B, 1))`` of ``model``
    returning the next tokens (B,) int32 (argmax of the last logits; ties
    go to the first index, as ``jnp.argmax``) and the new state; the
    caches are written in place."""
    def serve_step(params, state, tokens: torch.Tensor):
        logits, state = model.decode_step(params, state, tokens)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, state
    return serve_step


def build_serve_step(cfg: ModelConfig, mesh, shape: InputShape,
                     rules: Optional[dict] = None) -> StepBundle:
    """One decode step (:func:`make_serve_step` of ``cfg``'s model) for
    a seq_len-deep cache of global_batch sequences.

    With a ``mesh`` the bundle is the reference's: the model's KV heads
    repeated ``kv_repeat_for(cfg, mesh)`` times, ``in_shardings`` = (the
    params' placements under ``rules``, the state's, the tokens'),
    ``out_shardings`` = (the next tokens', the state's); on a rank mesh
    its ``fn`` runs on this rank's shards (a shape-only mesh reckons the
    placements only). ``args`` are the whole (global) inputs as ``meta``
    tensors."""
    if mesh is None:
        if rules is not None:
            raise ValueError("rules place a step on a mesh; pass mesh=")
        model = build_model(cfg)
    else:
        r = shd.kv_repeat_for(cfg, mesh)
        pspecs = shd.param_pspecs(build_model(cfg, r), mesh, rules)
        model = build_model(cfg, r, mesh=mesh, place=pspecs)
    B = shape.global_batch
    state_abs = model.decode_state_abstract(B, shape.seq_len)
    args = (model.abstract(), state_abs, _meta((B, 1), torch.int32))
    if mesh is None:
        return StepBundle(fn=make_serve_step(model), args=args,
                          in_shardings=None, out_shardings=None,
                          donate_argnums=(1,), model=model)
    state_specs = shd.decode_state_pspecs(model, state_abs, mesh, B)
    bp = shd.batch_pspec(mesh, B)
    tok_spec = bp + (None,) if bp != (None,) else ()
    out_tok_spec = bp if bp != (None,) else ()
    return StepBundle(
        fn=make_serve_step(model), args=args,
        in_shardings=(pspecs, state_specs, tok_spec),
        out_shardings=(out_tok_spec, state_specs),
        donate_argnums=(1,), model=model)


def build_step(cfg: ModelConfig, mesh, shape: InputShape,
               rules: Optional[dict] = None, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, rules=rules, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, rules=rules)
    return build_serve_step(cfg, mesh, shape, rules=rules)


# ---------------------------------------------------------------------------
# Placed inputs: per process, per rank
# ---------------------------------------------------------------------------

def _is_placement(spec) -> bool:
    """A placement (a tuple of mesh-axis names, tuples of them or None),
    as opposed to a tree of placements."""
    return (isinstance(spec, tuple) and not hasattr(spec, "_fields")
            and all(e is None or isinstance(e, str)
                    or (isinstance(e, tuple)
                        and all(isinstance(a, str) for a in e))
                    for e in spec))


def _map_placed(args, specs, fn):
    """``fn(tensor, placement)`` over every tensor of ``args``, the
    placements taken from ``specs``. A placement may sit above the args'
    structure (one placement for a whole ``SparseRows`` or state tuple,
    the reference's ``shard_map`` prefix semantics): it then applies to
    every tensor below it, over their leading dims."""
    if isinstance(args, torch.Tensor):
        return fn(args, specs)
    if sparse_rows.is_sparse(args):
        return sparse_rows.SparseRows(
            _map_placed(args.indices, specs, fn),
            _map_placed(args.values, specs, fn), args.d)
    if isinstance(args, dict):          # in sorted key order, as jax's
        out = {k: _map_placed(args[k], specs if _is_placement(specs)
                              else specs[k], fn) for k in sorted(args)}
        return {k: out[k] for k in args}
    if isinstance(args, tuple):
        sub = [specs] * len(args) if _is_placement(specs) else list(specs)
        out = [_map_placed(a, s, fn) for a, s in zip(args, sub)]
        return type(args)(*out) if hasattr(args, "_fields") \
            else tuple(out)
    return args


def per_host_abstract(args, in_shardings, mesh, num_processes: int):
    """The inputs each of ``num_processes`` processes makes of a bundle's
    global ``args`` (``meta`` tensors): every dim placed on a batch axis
    ("pod"/"data") divided by the process count, as the reference's
    (its data axes span the processes, each process holding a
    contiguous block of rows); ``meta`` tensors again. Raises
    ``ValueError`` when such a dim does not divide."""
    from repro_torch.launch.mesh import batch_axes
    data_ax = set(batch_axes(mesh))

    def one(a, spec):
        shape = list(a.shape)
        for i, entry in enumerate(spec or ()):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if set(axes) & data_ax:
                if shape[i] % num_processes:
                    raise ValueError(
                        f"dim {i} of {tuple(a.shape)} does not split "
                        f"over {num_processes} processes")
                shape[i] //= num_processes
        return _meta(tuple(shape), a.dtype)
    return _map_placed(args, in_shardings, one)


def local_abstract(args, in_shardings, mesh):
    """One rank's shards of a bundle's global ``args`` as ``meta``
    tensors: every placed dim divided by the ranks it is split over."""
    from repro_torch.models.layers import local_shape
    return _map_placed(args, in_shardings, lambda a, spec: _meta(
        local_shape(a.shape, spec or (), mesh), a.dtype))


# ---------------------------------------------------------------------------
# The paper's own workload as steps on a mesh (svm-tfidf "arch")
# ---------------------------------------------------------------------------

def _svm_shuffle(svm_cfg, shuffle_impl: Optional[str]) -> str:
    """Merge-transport choice: explicit override > config default."""
    return shuffle_impl if shuffle_impl is not None \
        else getattr(svm_cfg, "shuffle_impl", "allgather")


def _svm_mr_cfg(svm_cfg, shuffle_impl: Optional[str], ndev: int):
    """The ``MRSVMConfig`` of a launch step; for the two-level hier
    transport the host count of ``simulated_hier_hosts`` (None on a
    multi-process launch: the launched processes)."""
    from repro_torch.core.mapreduce_svm import MRSVMConfig
    from repro_torch.launch.mesh import simulated_hier_hosts
    shuffle = _svm_shuffle(svm_cfg, shuffle_impl)
    return MRSVMConfig(
        sv_capacity=svm_cfg.sv_capacity, shuffle_impl=shuffle,
        hier_num_hosts=simulated_hier_hosts(ndev) if shuffle == "hier"
        else None,
        svm=_svm_solver_cfg(svm_cfg))


def _svm_solver_cfg(svm_cfg):
    """The reducer ``SVMConfig`` of the workload config, carrying its row
    format, so that the whole sharded program keys off one switch."""
    from repro_torch.core.svm import SVMConfig
    rf = getattr(svm_cfg, "row_format", "dense")
    return SVMConfig(
        C=svm_cfg.C, max_epochs=svm_cfg.max_epochs, row_format=rf,
        nnz_cap=getattr(svm_cfg, "nnz_cap", 0) if rf == "sparse_csr"
        else 0)


def _svm_rows_abstract(svm_cfg, shape, dt):
    """A row batch of the workload's row format as ``meta`` tensors:
    dense, or ``SparseRows`` of ``nnz_cap`` slots a row."""
    if getattr(svm_cfg, "row_format", "dense") != "sparse_csr":
        return _meta(tuple(shape), dt)
    lead = tuple(shape[:-1]) + (svm_cfg.nnz_cap,)
    return sparse_rows.SparseRows(_meta(lead, torch.int32), _meta(lead, dt),
                                  shape[-1])


def _svm_axes(mesh):
    """(the batch axes' ranks, the rows' placement over them)."""
    from repro_torch.launch.mesh import batch_axes, data_parallel_size
    axes = batch_axes(mesh)
    return data_parallel_size(mesh), (axes if len(axes) > 1 else axes[0],)


def _on_ranks(mesh, make):
    """The step of this rank of a rank ``mesh`` (``make(group)`` with
    the rank's batch group); on a shape-only mesh a function that
    raises: it reckons the inputs only."""
    if mesh.coords is None:
        def fn(*args, **kw):
            mesh._need_ranks("step to run")
        return fn
    from repro_torch.launch.mesh import batch_group
    return make(batch_group(mesh))


def build_svm_round_step(svm_cfg, mesh,
                         shuffle_impl: Optional[str] = None) -> StepBundle:
    """One MapReduce-SVM round on ``mesh``: rows over the (pod,) data
    axes, the SV buffer replicated; the merge is the transport
    ``shuffle_impl`` names (default the config's). On a rank mesh
    ``fn(Xl, yl, ml, sv)`` runs this rank's shard
    (``core.mapreduce_svm.make_sharded_round`` over the rank's batch
    group) and returns (sv', risks, w, b). With more than one model
    rank, the hier transport's host groups are made within this rank's
    batch group only: a world of real ranks must make every group on
    every rank, so there it takes a mesh of one model rank."""
    from repro_torch.core.mapreduce_svm import SVBuffer, make_sharded_round
    ndev, row_spec = _svm_axes(mesh)
    per = svm_cfg.rows_per_device
    n, d = ndev * per, svm_cfg.num_features
    mr_cfg = _svm_mr_cfg(svm_cfg, shuffle_impl, ndev)
    rep = SVBuffer(x=(), y=(), alpha=(), ids=(), mask=())
    dt = getattr(torch, svm_cfg.dtype)
    cap = svm_cfg.sv_capacity
    args = (_svm_rows_abstract(svm_cfg, (n, d), dt), _meta((n,), dt),
            _meta((n,), dt),
            SVBuffer(x=_svm_rows_abstract(svm_cfg, (cap, d), dt),
                     y=_meta((cap,), dt), alpha=_meta((cap,), dt),
                     ids=_meta((cap,), torch.int32), mask=_meta((cap,), dt)))
    fn = _on_ranks(mesh, lambda g: make_sharded_round(mr_cfg, g, ndev, per))
    return StepBundle(fn=fn, args=args,
                      in_shardings=(row_spec, row_spec, row_spec, rep),
                      out_shardings=(rep, (), (), ()),
                      donate_argnums=(), model=None)


def _svm_sweep_bundle(svm_cfg, mesh, S: int, shuffle_impl, per: int,
                      per_config_data: bool) -> StepBundle:
    from repro_torch.core.svm import SolverParams
    from repro_torch.core.sweep import (DedupChunk, init_sharded_sweep_sv,
                                        make_sharded_sweep_round,
                                        uses_dedup_state)
    from repro_torch.core.mapreduce_svm import SVBuffer
    ndev, row_spec = _svm_axes(mesh)
    n, d = ndev * per, svm_cfg.num_features
    mr_cfg = _svm_mr_cfg(svm_cfg, shuffle_impl, ndev)
    dt = getattr(torch, svm_cfg.dtype)
    lead = (S, n) if per_config_data else (n,)
    data_spec = (None,) + row_spec if per_config_data else row_spec
    state = init_sharded_sweep_sv(mr_cfg, S, d, ndev, per, dt,
                                  per_config_data=per_config_data,
                                  device="meta")
    rep = (DedupChunk if uses_dedup_state(mr_cfg, per_config_data)
           else SVBuffer)(*(() for _ in state))
    rep_par = SolverParams(*(() for _ in SolverParams._fields))
    args = (_svm_rows_abstract(svm_cfg, lead + (d,), dt), _meta(lead, dt),
            _meta(lead, dt), state,
            SolverParams(*(_meta((S,), torch.float32)
                           for _ in SolverParams._fields)))
    fn = _on_ranks(mesh, lambda g: make_sharded_sweep_round(
        mr_cfg, g, ndev, per, per_config_data=per_config_data))
    return StepBundle(fn=fn, args=args,
                      in_shardings=(data_spec,) * 3 + (rep, rep_par),
                      out_shardings=(rep, (), (), ()),
                      donate_argnums=(), model=None)


def build_svm_sweep_step(svm_cfg, mesh, num_configs: int,
                         shuffle_impl: Optional[str] = None) -> StepBundle:
    """S = ``num_configs`` MapReduce-SVM jobs a round on ``mesh``: the
    sharded sweep round (``core.sweep.make_sharded_sweep_round``), a
    rank's S reducers one solve launch; on the packed transports the
    round state is the shared-row dedup format. On a rank mesh ``fn(Xl,
    yl, ml, state, params)`` runs this rank's shard (hier as in
    :func:`build_svm_round_step`)."""
    return _svm_sweep_bundle(svm_cfg, mesh, num_configs, shuffle_impl,
                             svm_cfg.rows_per_device, False)


def build_svm_serve_step(svm_cfg, mesh, num_streams: int = 4,
                         shuffle_impl: Optional[str] = None) -> StepBundle:
    """One streaming update wave on ``mesh``: S = ``num_streams`` tenant
    streams each fold (new rows ∪ carried SVs) at once, the sweep round
    with per-stream rows (``per_config_data``): ``stream_rows_per_wave
    + sv_capacity`` rows a stream over the batch axes, rounded up to
    whole ranks."""
    ndev, _ = _svm_axes(mesh)
    wave_rows = svm_cfg.stream_rows_per_wave + svm_cfg.sv_capacity
    return _svm_sweep_bundle(svm_cfg, mesh, num_streams, shuffle_impl,
                             -(-wave_rows // ndev), True)
