"""dp x tp batched engine: batch-as-heads decode on every rank.

Counterpart of ``pqcache_tpu/parallel/batch_tp.py``. Two parallel axes:

  * ``dp`` shards the SLOT pool: each data-parallel group owns B / dp
    sequence slots (its prompts, counters and KV / PQ state);
  * ``tp`` shards the heads within every slot, with the two all-reduces
    per layer of ``parallel/tp_decode.py``.

Each rank keeps its [L, B_loc, H_kv_loc, ...] block folded as the batched
policy reads it, [L, B_loc·H_kv_loc, ...] (``sharding._fold``), so a
rank's step is the single-device batched decode at the shard's shapes.
The JAX program keeps a 5-D global state and folds inside ``shard_map``;
here no process holds more than its own block.

Prefill runs in WAVES: wave w prefills, in every dp group at once, that
group's next prompt (tp-sharded compute) and inserts it at local slot w.
A group with nothing to admit in a wave leaves its state untouched (the
JAX program's predicated insert): the dp groups share no collective while
they prefill or decode, so that group simply skips the wave.

The decode step runs EAGERLY (``llama.decode_loop_batched`` with the tp
group): a gloo collective cannot be captured into a CUDA graph, and a
capture under a process group raises (``runtime/decode_graph.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pqcache_tpu_torch.config import EngineConfig
from pqcache_tpu_torch.core.budget import compute_budget
from pqcache_tpu_torch.models import llama, require_llama
from pqcache_tpu_torch.parallel.tp_decode import (check_replicated, left_pad,
                                                  local_model_config,
                                                  local_params)
from pqcache_tpu_torch.policies.base import get_policy
from pqcache_tpu_torch.runtime.generate import chunk_plan_capped


class BatchTPEngine:
    """B sequence slots over a (dp, tp) mesh (``factory.make_mesh``);
    batch-as-heads decode on every rank. params: the whole model, or with
    ``sharded`` this rank's shard; the engine keeps only the shard
    (``tp_decode.local_params``)."""

    def __init__(self, cfg: EngineConfig, params: dict, mesh,
                 prefill_len: int, max_new_tokens: int,
                 dtype=torch.bfloat16, interleave: str = "auto",
                 sharded: bool = False):
        """interleave: "auto" / "on" / "off", as ``BatchEngine``'s. With a
        chunked prefill, "on" and "auto" make ``serve_local`` admit
        slab-wise: one prompt slab per decode chunk instead of a whole
        prefill wave, so running streams stall at most one slab."""
        require_llama(cfg.model, "BatchTPEngine")
        if cfg.runtime.policy != "pq_search":
            raise ValueError("the TP engines run pq_search")
        self.mesh = mesh
        self.dp, self.tp = mesh.dp, mesh.tp
        self.comm = mesh.tp_comm
        self.device = mesh.device
        self.cfg_local = local_model_config(cfg, self.tp)
        # a chunked prefill rounds the slot length up to its chunk plan,
        # so every wave takes the chunked path (max_seq_len caps it; chunk
        # 0 means the cap forced one pass); callers pad prompts to self.P
        ch_eff = 0
        if cfg.runtime.prefill_chunk and prefill_len > cfg.runtime.prefill_chunk:
            prefill_len, ch_eff = chunk_plan_capped(
                prefill_len, cfg.runtime.prefill_chunk,
                cfg.runtime.max_seq_len)
        self.P = prefill_len
        self._pf_chunk = ch_eff
        self.max_new = max_new_tokens
        self.dtype = dtype
        self.params = local_params(params, mesh, dtype, sharded)
        self.budget = compute_budget(cfg.budget, prefill_len, max_new_tokens)
        self.policy = get_policy(self.cfg_local, self.budget,
                                 device=self.device)
        self.policy.shard = (mesh.tp_rank, self.tp)
        if interleave not in ("auto", "on", "off"):
            raise ValueError(f"interleave must be auto/on/off, "
                             f"got {interleave!r}")
        self.interleave = bool(ch_eff) and interleave != "off"
        if interleave == "on" and not self.interleave:
            raise ValueError("interleave='on' requires a chunked prefill "
                             "(runtime.prefill_chunk)")
        self.chunk = min(16, max(max_new_tokens - 1, 1))
        if self.policy.ring_k:
            self.chunk = min(self.chunk, self.policy.ring_k)
        self.timings: dict = {}

    # -- state ----------------------------------------------------------------

    def init_state(self, B: int):
        """This rank's zero state for B global slots (B % dp == 0): B / dp
        slots of H_kv / tp heads, folded."""
        if B % self.dp:
            raise ValueError(f"B={B} must be a multiple of dp={self.dp}")
        return self.policy.init_batched_state(B // self.dp, self.dtype)

    # -- prefill ----------------------------------------------------------------

    @torch.no_grad()
    def prefill_slot(self, bstate, ids, lslot: int) -> torch.Tensor:
        """Prefill prompt ``ids`` and insert it at local slot ``lslot``;
        returns its last-token logits [V] (replicated over tp)."""
        tokens, pad, true_len = left_pad(ids, self.P, self.device)
        single = self.policy.init_state(self.dtype)
        m = self.cfg_local.model
        if self._pf_chunk:
            logits = llama.prefill_chunked(m, self.params, self.policy,
                                           single, tokens, pad, true_len,
                                           chunk=self._pf_chunk,
                                           comm=self.comm)
        else:
            logits = llama.prefill(m, self.params, self.policy, single,
                                   tokens, pad, true_len, comm=self.comm)
        self.policy.insert_slot(bstate, single, lslot)
        return logits

    def prefill_wave(self, bstate, ids, lslot: int,
                     admit: bool = True) -> Optional[int]:
        """This dp group's part of a wave: ``prefill_slot`` and the first
        token. admit=False (nothing to admit in this group) leaves the
        state untouched and returns None."""
        if not admit:
            return None
        logits = self.prefill_slot(bstate, ids, lslot)
        return check_replicated(self.comm, torch.argmax(logits)[None])[0]

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def decode_chunk(self, bstate, toks, poss) -> list:
        """One chunk of ``self.chunk`` steps for every local slot, from
        tokens and positions [B_loc] (host sequences); returns the tokens
        [B_loc][chunk]."""
        out = llama.decode_loop_batched(
            self.cfg_local.model, self.params, self.policy, bstate,
            torch.as_tensor(np.asarray(toks), dtype=torch.int32,
                            device=self.device),
            torch.as_tensor(np.asarray(poss), dtype=torch.int32,
                            device=self.device),
            self.chunk, comm=self.comm)
        return [list(r) for r in zip(*check_replicated(self.comm, out))]

    def _run_group(self, local_prompts: list, max_new_tokens: int,
                   eos_ids, world) -> list:
        """Prefill waves and decode chunks of this dp group's slots until
        every slot of every group is done (``world``: the comm that agrees
        on it, None alone)."""
        from pqcache_tpu_torch.parallel.dcn import all_hosts_done
        if max_new_tokens > self.max_new:
            raise ValueError("max_new_tokens exceeds engine reservation")
        B_loc = len(local_prompts)
        t0 = time.perf_counter()
        bstate = self.policy.init_batched_state(B_loc, self.dtype)
        outs = [[self.prefill_wave(bstate, ids, w)]
                for w, ids in enumerate(local_prompts)]
        t1 = time.perf_counter()
        poss = np.asarray([len(np.asarray(p)) for p in local_prompts])
        done = [o[0] in eos_ids or max_new_tokens <= 1 for o in outs]
        steps = 0
        while not all_hosts_done(all(done), world):
            if all(done):
                continue
            t_np = self.decode_chunk(bstate, [o[-1] for o in outs], poss)
            poss = poss + self.chunk
            steps += self.chunk
            for i in range(B_loc):
                for t in ([] if done[i] else t_np[i]):
                    outs[i].append(int(t))
                    if int(t) in eos_ids or len(outs[i]) >= max_new_tokens:
                        done[i] = True
                        break
        self.timings = {"prefill_s": t1 - t0,
                        "decode_s": time.perf_counter() - t1, "steps": steps}
        return [o[:max_new_tokens] for o in outs]

    def generate_batch(self, prompts: list, max_new_tokens: int,
                       eos_ids=()) -> list:
        """Prefill and decode B = len(prompts) sequences (B % dp == 0); dp
        group g serves prompts [g·B/dp, (g+1)·B/dp). Every rank returns
        all B token lists, in prompt order."""
        B = len(prompts)
        if B % self.dp:
            raise ValueError(f"B={B} must be a multiple of dp={self.dp}")
        B_loc = B // self.dp
        g = self.mesh.dp_rank
        mine = self._run_group(list(prompts[g * B_loc:(g + 1) * B_loc]),
                               max_new_tokens, eos_ids, self.mesh.world_comm)
        if self.mesh.dp_comm is None:
            return mine
        return [o for part in self.mesh.dp_comm.all_gather_object(mine)
                for o in part]
