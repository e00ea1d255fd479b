"""Multi-host serving: every dp group feeds its own request queue.

Counterpart of ``pqcache_tpu/parallel/dcn.py``. The layout is the JAX
package's:

    dp (slot pool)  ->  OUTER axis, may span hosts
    tp (heads)      ->  INNER axis, stays inside one host

so the per-token all-reduces of the tp group never leave a host, and the
dp axis needs no collective during prefill or decode: each dp group owns
its slots end to end, and the groups agree only on when to stop
(``all_hosts_done``, one all-reduce of a flag per decode chunk).

One process per rank: a JAX process that holds several dp groups' devices
is here the ranks of those groups, and "this process's queue" is this dp
group's queue, handed alike to each of its tp ranks. So no process holds
another group's prompts or tokens, which is what ``host_local_rows`` and
``read_local_rows`` guarantee in the JAX package; here a rank's rows are
simply its own tensors. The JAX package's ``global_params`` (host-local
arrays lifted into global ones) has no counterpart: every engine slices
its own shard (``tp_decode.local_params``).

  * ``init_distributed(backend)``: the ``env://`` rendezvous that
    ``torchrun`` sets up (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); a
    no-op in a single process or once initialized.
  * ``serving_mesh(dp, tp)``: ``factory.make_mesh`` over the world.
  * ``DistributedBatchTPEngine``: ``serve_local``, continuous batching of
    the group's queue (admit into free slots between decode chunks,
    retire finished ones; slab-wise admission with a chunked prefill),
    and ``generate_batch_local``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from pqcache_tpu_torch.config import ParallelConfig
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.parallel.batch_tp import BatchTPEngine
from pqcache_tpu_torch.parallel.factory import RankMesh, make_mesh
from pqcache_tpu_torch.parallel.tp_decode import check_replicated, left_pad


def init_distributed(backend: str, device=None) -> None:
    """Join the ``torchrun`` world (``env://``) over ``backend`` ("nccl"
    where each rank has its own card, "gloo" otherwise); ``device``, when
    given, becomes this process's current CUDA device. A no-op when the
    environment names no world of more than one process, or when the
    world is already initialized."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method="env://")


def serving_mesh(dp: int, tp: int, *, device=None) -> RankMesh:
    """This rank's place in the (dp, tp) serving mesh, dp outermost (the
    ranks of a dp group are consecutive, so a host's ranks hold whole tp
    groups)."""
    return make_mesh(ParallelConfig(data=dp, tensor=tp), device)


def host_local_rows(mesh: RankMesh, n_rows: int, local_rows,
                    dtype=torch.int64) -> torch.Tensor:
    """This dp group's rows [n_rows / dp, ...] of a dp-sharded array of
    n_rows rows, as a tensor on the rank's device; the shape is checked
    against the split, and no other group's rows are ever passed."""
    t = torch.as_tensor(np.asarray(local_rows), dtype=dtype,
                        device=mesh.device)
    if n_rows % mesh.dp or t.shape[0] != n_rows // mesh.dp:
        raise ValueError(f"{t.shape[0]} local rows is not this group's "
                         f"share of {n_rows} over dp={mesh.dp}")
    return t


def read_local_rows(mesh: RankMesh, arr: torch.Tensor):
    """(rows as numpy, this group's global row offset) of the group's
    block of a dp-sharded array."""
    return arr.cpu().numpy(), mesh.dp_rank * arr.shape[0]


def all_hosts_done(local_done: bool, comm=None) -> bool:
    """Termination agreement: True when ``local_done`` holds on every rank
    of ``comm`` (all_reduce MIN of a flag); identity alone."""
    return local_done if comm is None else comm.all_true(local_done)


class DistributedBatchTPEngine(BatchTPEngine):
    """BatchTPEngine whose dp groups each feed their own requests: a group
    passes only its prompts and reads back only its tokens."""

    def generate_batch_local(self, local_prompts: Sequence,
                             max_new_tokens: int, eos_ids=()) -> list:
        """Run this dp group's len(local_prompts) slots (the same count on
        every group); returns this group's token lists. Every rank calls it
        collectively."""
        return self._run_group(list(local_prompts), max_new_tokens, eos_ids,
                               self.mesh.world_comm)

    @torch.no_grad()
    def serve_local(self, requests: Sequence, max_new_tokens: int,
                    eos_ids=(), slots_per_group: int = 1) -> dict:
        """Continuous batching of this group's queue of (seq_id,
        prompt_ids) over ``slots_per_group`` slots: finished slots retire
        and queued requests admit between decode chunks. A monolithic
        admission prefills a whole prompt (one wave per free slot); with
        ``self.interleave`` (chunked prefill) one admission at a time
        advances one prompt slab per decode chunk (``llama.
        prefill_chunk_step``, then ``prefill_finish_tail``), so the running
        streams stall at most one slab. Token streams are the same either
        way. Every rank calls this collectively; returns {seq_id: tokens}
        of this group's requests."""
        if max_new_tokens > self.max_new:
            raise ValueError("max_new_tokens exceeds engine reservation")
        world = self.mesh.world_comm
        B_loc = slots_per_group
        queue = list(requests)
        results: dict = {}
        bstate = self.policy.init_batched_state(B_loc, self.dtype)
        slots = [{"done": True, "sid": None, "toks": None, "pos": 0}
                 for _ in range(B_loc)]
        m = self.cfg_local.model

        def start(w, first, sid, tlen):
            slots[w] = {"done": first in eos_ids or max_new_tokens <= 1,
                        "sid": sid, "toks": [first], "pos": tlen}
            if slots[w]["done"]:
                results[sid] = slots[w]["toks"]

        def decode_once():
            t_np = self.decode_chunk(
                bstate, [s["toks"][-1] if s["toks"] else 0 for s in slots],
                [s["pos"] for s in slots])
            for s, row in zip(slots, t_np):
                s["pos"] += self.chunk
                if s["done"]:
                    continue
                for t in row:
                    s["toks"].append(int(t))
                    if int(t) in eos_ids or len(s["toks"]) >= max_new_tokens:
                        s["done"] = True
                        results[s["sid"]] = s["toks"][:max_new_tokens]
                        break

        if not self.interleave:
            while True:
                for w in range(B_loc):
                    if slots[w]["done"] and queue:
                        sid, ids = queue.pop(0)
                        start(w, self.prefill_wave(bstate, ids, w), sid,
                              len(ids))
                idle = all(s["done"] for s in slots)
                if all_hosts_done(idle and not queue, world):
                    return results
                if not idle:
                    decode_once()

        ch = self._pf_chunk
        pending = None
        wave_w = 0
        while True:
            if pending is None:
                w = wave_w
                wave_w = (wave_w + 1) % B_loc
                if slots[w]["done"] and queue:
                    sid, ids = queue.pop(0)
                    tokens, pad, tlen = left_pad(ids, self.P, self.device)
                    kbuf = torch.zeros((m.num_layers, m.num_kv_heads, self.P,
                                        m.head_dim), dtype=self.dtype,
                                       device=self.device)
                    pending = {"w": w, "sid": sid, "tokens": tokens,
                               "pad": pad, "tlen": tlen, "kbuf": kbuf,
                               "vbuf": torch.zeros_like(kbuf), "i": 0}
            idle = all(s["done"] for s in slots)
            if all_hosts_done(pending is None and idle and not queue,
                              world):
                return results
            if not idle:
                decode_once()
            if pending is not None:
                c0 = pending["i"] * ch
                h = llama.prefill_chunk_step(
                    m, self.params, pending["kbuf"], pending["vbuf"],
                    llama.embed_lookup(self.params,
                                       pending["tokens"][c0:c0 + ch]),
                    pending["pad"], c0, use_kernel=self.policy.use_kernel,
                    comm=self.comm)
                pending["i"] += 1
                if pending["i"] * ch == self.P:
                    single = self.policy.init_state(self.dtype)
                    logits = llama.prefill_finish_tail(
                        m, self.params, self.policy, single,
                        pending["kbuf"], pending["vbuf"], h, pending["pad"],
                        pending["tlen"])
                    self.policy.insert_slot(bstate, single, pending["w"])
                    first = check_replicated(
                        self.comm, torch.argmax(logits)[None])[0]
                    start(pending["w"], first, pending["sid"],
                          pending["tlen"])
                    pending = None
