"""Rank bodies of the parallel engines, for ``launch.launch``.

Each function runs in one rank process: ``fn(ctx, *args)`` with ``ctx`` a
``launch.RankContext``; it builds its mesh, runs one engine and returns
picklable results (tokens, logits on the CPU, the comm's route / byte /
time counts, the kernel launch counts of this process, its peak device
memory). ``spawn`` imports this module in every child, so it imports no
JAX. The parity tests and ``chip_smoke.py``'s parallel phase drive the
engines through these.

``params`` is either a params dict of the whole model (sent to the rank,
which slices its shard before moving it to its device) or an int seed: the
rank then draws its own shard of the random model on its device from that
seed (``sharding.init_params_shard``: ``llama.init_params``'s values, one
layer's matrix at a time), so no process holds the whole model and no
gigabytes move between processes.

``seed_draws``, where a body takes it, is a table of k-means++ draws that
the rank seeds every k-means from (``core/pq.use_seed_draws``): the parity
tests hand in the JAX package's draws for the run's shapes.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pqcache_tpu_torch.config import ParallelConfig
from pqcache_tpu_torch.core import pq
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.ops.adc import adc_block_scores, adc_scores
from pqcache_tpu_torch.ops.block_attn import block_topk_attention
from pqcache_tpu_torch.ops.flash_attention import flash_attention
from pqcache_tpu_torch.ops.flash_scores import flash_scores
from pqcache_tpu_torch.ops.gather import gather_rows
from pqcache_tpu_torch.ops.jhist import jhist_block_mass
from pqcache_tpu_torch.ops.w8 import w8_matmul
from pqcache_tpu_torch.parallel.factory import make_mesh

KERNELS = {"flash_attention": flash_attention, "flash_scores": flash_scores,
           "block_topk_attention": block_topk_attention,
           "adc_scores": adc_scores, "adc_block_scores": adc_block_scores,
           "gather_rows": gather_rows, "w8_matmul": w8_matmul,
           "jhist_block_mass": jhist_block_mass}


def _zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def _params(ctx, mesh, cfg, params, dtype) -> dict:
    """This rank's tp shard of ``params`` (a dict or a seed) on its device
    in ``dtype``; the engines take it with ``sharded=True``. A seed draws
    the bf16 model (``llama.init_params``' default), as the single-process
    references draw it, whatever ``dtype`` it then runs in."""
    from pqcache_tpu_torch.parallel.sharding import init_params_shard
    from pqcache_tpu_torch.parallel.tp_decode import local_params
    if isinstance(params, int):
        params = init_params_shard(
            cfg.model, torch.Generator(device=ctx.device).manual_seed(params),
            mesh.tp_rank, mesh.tp, device=ctx.device)
        return local_params(params, mesh, dtype, sharded=True)
    return local_params(params, mesh, dtype)


def _sync(ctx) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _report(ctx, mesh, out: dict) -> dict:
    """Adds this rank's comm counts, kernel counts and peak memory."""
    comms = {"tp": mesh.tp_comm, "dp": mesh.dp_comm, "world": mesh.world_comm}
    out["comm"] = {k: {op: dict(st) for op, st in c.stats.items()}
                   for k, c in comms.items() if c is not None}
    out["launches"] = _counts()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                         if ctx.device.type == "cuda" else None)
    out["rank"] = ctx.rank
    return out


def _forced(eng_cfg, params, policy, state, pos: int, tokens, comm, dev):
    """Logits [n, V] after each of tokens[:-1] fed back in turn (teacher
    forcing), on the CPU."""
    out = []
    for i, t in enumerate(tokens[:-1]):
        out.append(llama.decode_step(eng_cfg.model, params, policy, state,
                                     torch.tensor(int(t), device=dev),
                                     pos + i, comm).float().cpu())
    return torch.stack(out)


def _swap_wo(eng) -> None:
    """A planted fault for negative controls: every rank takes the previous
    rank's wo rows (its heads' outputs meet another shard's projection)."""
    lay = eng.local["layers"]
    lay["wo"] = eng.comm.ring_shift([lay["wo"]])[0]


def _tp_run(ctx, mesh, cfg, params, prompt, prefill_len: int, max_new: int,
            *, ring: bool, forced, dtype, forced_cfg=None,
            fault: bool = False) -> dict:
    from pqcache_tpu_torch.parallel.tp_decode import TPEngine
    eng = TPEngine(cfg, params, mesh, prefill_len, max_new, dtype=dtype,
                   sharded=True)
    for c in (mesh.tp_comm, mesh.world_comm):
        if c is not None:
            c.reset_stats()
    _zero_counts()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx)
    t0 = time.perf_counter()
    run = eng.generate_ring if ring else eng.generate
    toks = run(prompt, max_new)
    _sync(ctx)
    out = _report(ctx, mesh, {"tokens": toks,
                              "seconds": time.perf_counter() - t0,
                              "timings": dict(eng.timings)})
    if forced is not None:
        if forced_cfg is not None:
            del eng
            eng = TPEngine(forced_cfg, params, mesh, prefill_len, max_new,
                           dtype=dtype, sharded=True)
        if fault:
            _swap_wo(eng)
        state, lg, true_len = eng.prefill(prompt, max_new, ring=ring)
        with torch.no_grad():
            out["forced_logits"] = torch.cat([
                lg.float().cpu()[None],
                _forced(eng.cfg_local, eng.local, eng.policy, state,
                        true_len, forced, eng.comm, ctx.device)])
    return out


def tp_generate(ctx, cfg, params, prompt, prefill_len: int, max_new: int,
                *, ring: bool = False, forced=None, forced_cfg=None,
                timed: bool = False, dtype=torch.float32,
                seed_draws=None) -> dict:
    """TPEngine over every rank (tp = world): ``generate`` (or
    ``generate_ring``) of ``prompt``; with ``forced`` tokens, a second
    prefill (under ``forced_cfg`` when given) and the logits
    [len(forced), V] of the prefill and of each forced step (teacher
    forcing). ``timed`` times the collectives on the host clock (the
    device synchronised around each)."""
    return tp_runs(ctx, params, [dict(
        cfg=cfg, prompt=prompt, prefill_len=prefill_len, max_new=max_new,
        ring=ring, forced=forced, forced_cfg=forced_cfg, timed=timed)],
        dtype=dtype, seed_draws=seed_draws)[0]


def tp_runs(ctx, params, runs: list, dtype=torch.float32,
            seed_draws=None) -> list:
    """Several ``tp_generate`` runs in one world, the weights drawn or
    moved once: ``runs[i]`` holds tp_generate's arguments by name (cfg,
    prompt, prefill_len, max_new; ring, forced, forced_cfg, timed, fault
    optional: ``fault`` plants ``_swap_wo`` in the forced run, a negative
    control). Returns their results in order."""
    pq.use_seed_draws(seed_draws)
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    p = _params(ctx, mesh, runs[0]["cfg"], params, dtype)
    out = []
    for r in runs:
        if mesh.tp_comm is not None:
            mesh.tp_comm.timed = r.get("timed", False)
        out.append(_tp_run(ctx, mesh, r["cfg"], p, r["prompt"],
                           r["prefill_len"], r["max_new"],
                           ring=r.get("ring", False), forced=r.get("forced"),
                           dtype=dtype, forced_cfg=r.get("forced_cfg"),
                           fault=r.get("fault", False)))
    return out


def tp_decode_state(ctx, cfg, params, state, first: int, pos: int,
                    n_steps: int, prefill_len: int, max_new: int, *,
                    forced=None, prompt=None) -> dict:
    """Decode of ``n_steps`` from a GLOBAL single-sequence PQState (a JAX
    TPEngine's prefill state moved across by ``bridge``, or a
    single-process engine's) of a TPEngine of ``prefill_len`` /
    ``max_new``, each rank taking its kv-head slice (``sharding.
    shard_state``): greedy, or with ``forced`` fed forced[i] at step i.
    Returns the tokens and the logits [n_steps, V] of each step; with
    ``prompt``, also how far this rank's own prefill of it trained the
    same codebooks as the state's slice (``codes_agree``: the share of
    equal codes over the candidates; ``centroids_max_diff``) and, with
    ``forced`` too, the teacher-forced logits [n_steps + 1, V] from that
    own prefill (``own_logits``: the prefill's, then each step's)."""
    from pqcache_tpu_torch.parallel.sharding import shard_state
    from pqcache_tpu_torch.parallel.tp_decode import TPEngine
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    dtype = state.k_sink.dtype
    eng = TPEngine(cfg, _params(ctx, mesh, cfg, params, dtype), mesh,
                   prefill_len, max_new, dtype=dtype, sharded=True)
    st = shard_state(state, mesh.tp_rank, mesh.tp)
    st = dataclasses.replace(st, **{
        f.name: getattr(st, f.name).to(ctx.device)
        for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)})
    out = {}
    if prompt is not None:
        own, lg, true_len = eng.prefill(prompt, max_new)
        n = int(st.n_cand)
        out["codes_agree"] = (own.codes[..., :n] == st.codes[..., :n]
                              ).float().mean().item()
        out["centroids_max_diff"] = (own.centroids.float()
                                     - st.centroids.float()).abs().max(
                                         ).item()
        if forced is not None:
            with torch.no_grad():
                out["own_logits"] = torch.cat([
                    lg.float().cpu()[None],
                    _forced(eng.cfg_local, eng.local, eng.policy, own,
                            true_len, forced[:n_steps + 1], eng.comm,
                            ctx.device)])
        del own
    logits, toks = [], []
    with torch.no_grad():
        for i in range(n_steps):
            tok = (first if i == 0 else
                   toks[-1] if forced is None else int(forced[i]))
            lg = llama.decode_step(eng.cfg_local.model, eng.local, eng.policy,
                                   st, torch.tensor(tok, device=ctx.device),
                                   pos + i, eng.comm)
            logits.append(lg.float().cpu())
            toks.append(int(torch.argmax(lg)))
    out.update(tokens=toks, logits=torch.stack(logits))
    return out


def batch_forced_logits(eng, local_prompts, forced) -> torch.Tensor:
    """Teacher forcing on a BatchTPEngine (``factory.make_mesh`` of one
    device gives the single-device batched path): this group's prompts
    prefilled afresh, then slot s fed forced[s][:-1] in turn, the ring
    flushed every ``eng.chunk`` steps as the decode chunks flush it.
    Returns the logits [n, B_loc, V] (the prefill's, then each step's) on
    the CPU."""
    bstate = eng.policy.init_batched_state(len(local_prompts), eng.dtype)
    with torch.no_grad():
        out = [torch.stack([eng.prefill_slot(bstate, ids, w).float().cpu()
                            for w, ids in enumerate(local_prompts)])]
        n = min(len(f) for f in forced) - 1
        for i in range(n):
            t = torch.tensor([f[i] for f in forced], dtype=torch.int32,
                             device=eng.device)
            p = torch.tensor([len(q) + i for q in local_prompts],
                             dtype=torch.int32, device=eng.device)
            out.append(llama.decode_step_batched(
                eng.cfg_local.model, eng.params, eng.policy, bstate, t, p,
                eng.comm).float().cpu())
            if (i + 1) % eng.chunk == 0 and eng.policy.ring_k:
                eng.policy.flush_ring_batched(bstate)
    return torch.stack(out)


def batch_generate(ctx, cfg, params, dp: int, prompts, prefill_len: int,
                   max_new: int, *, forced=None, forced_cfg=None,
                   timed: bool = False, dtype=torch.float32,
                   seed_draws=None) -> dict:
    """BatchTPEngine over a (dp, world / dp) mesh: ``generate_batch`` of
    all prompts (every rank returns all of them); with ``forced`` (a token
    list per prompt), the group's teacher-forced logits
    (``batch_forced_logits``, under ``forced_cfg`` when given) from its
    first tp rank."""
    from pqcache_tpu_torch.parallel.batch_tp import BatchTPEngine
    pq.use_seed_draws(seed_draws)
    mesh = make_mesh(ParallelConfig(dp, ctx.world // dp), ctx.device)
    params = _params(ctx, mesh, cfg, params, dtype)
    eng = BatchTPEngine(cfg, params, mesh, prefill_len, max_new, dtype=dtype,
                        sharded=True)
    if mesh.tp_comm is not None:
        mesh.tp_comm.timed = timed
    _zero_counts()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx)
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, max_new)
    _sync(ctx)
    out = _report(ctx, mesh, {"tokens": outs,
                              "seconds": time.perf_counter() - t0,
                              "timings": dict(eng.timings),
                              "dp_rank": mesh.dp_rank})
    if forced is not None:
        if forced_cfg is not None:
            del eng
            eng = BatchTPEngine(forced_cfg, params, mesh, prefill_len,
                                max_new, dtype=dtype, sharded=True)
        B_loc = len(prompts) // dp
        sl = slice(mesh.dp_rank * B_loc, (mesh.dp_rank + 1) * B_loc)
        lg = batch_forced_logits(eng, prompts[sl], forced[sl])
        out["forced_logits"] = lg if mesh.tp_rank == 0 else None
    return out


def serve_local(ctx, cfg, params, dp: int, queues, prefill_len: int,
                max_new: int, *, slots: int = 1, interleave: str = "auto",
                dtype=torch.float32, seed_draws=None) -> dict:
    """DistributedBatchTPEngine over a (dp, world / dp) mesh: dp group g
    serves ``queues[g]`` (its own queue of (seq_id, prompt); the queues are
    equally long); then, as references, static ``generate_batch`` runs of
    the queues' j-th requests (one per group) and ``generate_batch_local``
    of the group's first ``slots`` prompts."""
    from pqcache_tpu_torch.parallel.dcn import DistributedBatchTPEngine
    pq.use_seed_draws(seed_draws)
    mesh = make_mesh(ParallelConfig(dp, ctx.world // dp), ctx.device)
    eng = DistributedBatchTPEngine(cfg, _params(ctx, mesh, cfg, params,
                                                dtype),
                                   mesh, prefill_len, max_new, dtype=dtype,
                                   interleave=interleave, sharded=True)
    mine = queues[mesh.dp_rank]
    served = eng.serve_local(mine, max_new, slots_per_group=slots)
    static = {}
    for j in range(len(mine)):
        toks = eng.generate_batch([q[j][1] for q in queues], max_new)
        static.update({q[j][0]: t for q, t in zip(queues, toks)})
    local = eng.generate_batch_local([p for _, p in mine[:slots]], max_new)
    return {"served": served, "static": static, "local": local,
            "dp_rank": mesh.dp_rank, "interleave": eng.interleave}


def hosts_done(ctx) -> list:
    """all_hosts_done over the world with the flag true on rank 0 only, then
    on every rank."""
    from pqcache_tpu_torch.parallel.dcn import all_hosts_done
    mesh = make_mesh(ParallelConfig(ctx.world, 1), ctx.device)
    return [all_hosts_done(ctx.rank == 0, mesh.world_comm),
            all_hosts_done(True, mesh.world_comm)]


def ring_attention_slices(ctx, q, k, v, kvalid, inner: int) -> torch.Tensor:
    """ring_attention of this rank's slice of the full q/k/v [Hx, T, D]
    (kvalid [T]); returns the rank's output slice."""
    from pqcache_tpu_torch.parallel.ring_prefill import ring_attention
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    C = q.shape[1] // ctx.world
    sl = slice(ctx.rank * C, (ctx.rank + 1) * C)
    pos = torch.arange(q.shape[1])[sl]
    return ring_attention(q[:, sl], k[:, sl], v[:, sl], pos, pos, kvalid[sl],
                          mesh.tp_comm, inner=inner)


def kmeans_slices(ctx, x, valid, n_clusters: int, iters: int,
                  init=None) -> tuple:
    """Distributed Lloyd over this rank's slice of the points x [G, N, d]
    (valid [N] bool): (centroids, this slice's codes)."""
    from pqcache_tpu_torch.core import pq
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    C = x.shape[1] // ctx.world
    sl = slice(ctx.rank * C, (ctx.rank + 1) * C)
    res = pq.kmeans(x[:, sl], n_clusters, iters, init_centroids=init,
                    valid_mask=valid[None, sl], comm=mesh.tp_comm)
    return res.centroids, res.codes


def gather_state(ctx, cfg, params, prompt, prefill_len: int,
                 seed_draws=None) -> dict:
    """The ring prefill's handoff state (``gather_state_tp``) of this rank
    and its logits, beside the TP prefill's."""
    from pqcache_tpu_torch.parallel.tp_decode import TPEngine
    pq.use_seed_draws(seed_draws)
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    eng = TPEngine(cfg, params, mesh, prefill_len, 2, dtype=torch.float32)
    ring_st, lg_r, _ = eng.prefill(prompt, 2, ring=True)
    tp_st, lg, _ = eng.prefill(prompt, 2)
    return {"ring": ring_st, "tp": tp_st, "ring_logits": lg_r,
            "tp_logits": lg}


def offload_forced_logits(core, prompts, forced) -> torch.Tensor:
    """Teacher forcing on a BatchOffloadEngine (the single-device one, or a
    rank's core): ``generate_batch`` of the prompts, slot s fed
    forced[s][:-1] in turn. Returns the logits [n, B, V] (the prefill's,
    then each step's) on the CPU."""
    core.logits_log = []
    core.generate_batch(prompts, min(len(f) for f in forced), forced=forced)
    seen, core.logits_log = core.logits_log, None
    B = len(prompts)
    return torch.cat([torch.stack(seen[:B])[None], torch.stack(seen[B:])])


def offload_generate(ctx, cfg, params, dp: int, prompts, max_new: int, *,
                     ring: bool = False, forced=None, forced_cfg=None,
                     timed: bool = False, dtype=torch.float32,
                     seed_draws=None) -> dict:
    """ShardedOffloadEngine over a (dp, world / dp) mesh: ``generate_batch``
    of the prompts, or ``generate_ring`` of the one prompt; with ``forced``
    (dp 1), the teacher-forced logits (``offload_forced_logits``, under
    ``forced_cfg`` when given) from the first rank."""
    from pqcache_tpu_torch.parallel.offload_tp import ShardedOffloadEngine
    pq.use_seed_draws(seed_draws)
    mesh = make_mesh(ParallelConfig(dp, ctx.world // dp), ctx.device)
    params = _params(ctx, mesh, cfg, params, dtype)
    eng = ShardedOffloadEngine(cfg, params, mesh, batch_size=len(prompts),
                               dtype=dtype, sharded=True)
    if mesh.tp_comm is not None:
        mesh.tp_comm.timed = timed
    _zero_counts()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _sync(ctx)
    t0 = time.perf_counter()
    outs = (eng.generate_ring(prompts[0], max_new) if ring
            else eng.generate_batch(prompts, max_new))
    _sync(ctx)
    seconds = time.perf_counter() - t0
    out = _report(ctx, mesh, {"tokens": outs, "seconds": seconds,
                              "hit_rate": eng.hit_rate,
                              "timings": dict(eng.core.timings)})
    if forced is not None:
        if forced_cfg is not None:
            del eng
            eng = ShardedOffloadEngine(forced_cfg, params, mesh,
                                       batch_size=len(prompts), dtype=dtype,
                                       sharded=True)
        lg = offload_forced_logits(eng.core, prompts, forced)
        out["forced_logits"] = lg if ctx.rank == 0 else None
    return out


def comm_ops(ctx, fail_rank=None) -> dict:
    """Every ``Comm`` operation once on this rank's device (a raise on rank
    ``fail_rank``, to check the launcher's failure path); returns the
    results on the CPU with the comm's routes and counts."""
    if ctx.rank == fail_rank:
        raise RuntimeError(f"planted failure on rank {ctx.rank}")
    mesh = make_mesh(ParallelConfig(1, ctx.world), ctx.device)
    c, r, dev = mesh.tp_comm, ctx.rank, ctx.device
    blocks = torch.arange(ctx.world * 6, dtype=torch.float32,
                          device=dev).reshape(ctx.world * 2, 3) + 100 * r
    shifted = c.ring_shift([torch.full((4,), float(r), device=dev),
                            torch.tensor([r], device=dev)])
    return {
        "all_reduce": c.all_reduce(torch.full(
            (3,), float(r + 1), dtype=torch.bfloat16, device=dev)).cpu(),
        "all_reduce_max": c.all_reduce(torch.tensor(
            [float(r)], device=dev), op="max").cpu(),
        "all_gather": c.all_gather(torch.full((2, 1), float(r), device=dev),
                                   dim=1).cpu(),
        "all_to_all": c.all_to_all(blocks, split_dim=0, concat_dim=1).cpu(),
        "ring_shift": [t.cpu() for t in shifted],
        "all_true": (c.all_true(r == 0), c.all_true(True)),
        "stats": c.stats}
