"""Batched decode replayed from a CUDA graph.

The JAX package runs a whole decode chunk as one compiled program
(``pqcache_tpu/models/llama.py::decode_loop_batched``, jitted by the
bench). Run op by op from Python, a decode step of the port issues
thousands of launches, and the host, not the card, sets its pace. The
port's counterpart of that program is a captured ``torch.cuda.CUDAGraph``
of one decode step (every layer, the appends, the counters' advance and the
next token), replayed once per step of a chunk; the chunk's ring flush
then runs eagerly, as the JAX program ends with it.

One step, not the whole chunk, is captured: a chunk graph would hold ring_k
times the nodes and bake each step's ring column into them, while the step
graph reads the ring column, like every other count, from the card
(``ring_r``, ``n_cand``, the per-slot positions).

The step's inputs and outputs are static device buffers: the tokens and
positions [B], the batched state (updated in place) and the chunk's token
buffer [chunk, B], row i holding step i's token. A sampled decode
(``sample`` from ``core/sampling.make_sampler``) reads its Gumbel noise
[B, V] from one more static buffer, which ``noise`` (a
``core/sampling.GumbelNoise``) refills eagerly before each step, outside
the graph: a replayed step and an eager one draw the same noise from the
same generator state, so they give the same tokens. The first step of
the first chunk runs eagerly on a side stream, under
``torch.cuda.set_sync_debug_mode("error")``: it builds the kernels and sets
their attributes outside the capture and shows that the step reads nothing
on the host. A failed capture raises; eager decoding is there only when
asked for (``graph=False``), and a CPU device takes only that.

Kernel wrappers count a launch when they are called, so a captured step
adds its kernels to the counts once, at capture, and a replay adds nothing;
``replays`` counts the replays.

The state has room for the ``max_new_tokens`` its policy's budget reserved
past each slot's prompt, and a write past the end would be clamped onto the
last rows on the card without a word. A standalone decoder counts its steps
on the host and raises before it takes more. A serving engine, whose slots
retire and admit while the pool decodes on, passes ``check_room=False`` and
checks each live slot's own room instead (``runtime/batch_engine.py``); a
finished slot decodes on past its reservation until it is retired, its
writes clamped inside its own rows, and its tokens are dropped.
"""

from __future__ import annotations

import time

import torch

from pqcache_tpu_torch import resolve_device
from pqcache_tpu_torch.config import ModelConfig
from pqcache_tpu_torch.models import llama
from pqcache_tpu_torch.runtime.stages import stage


class BatchedDecoder:
    """Batched decode of ``state`` in chunks of at most ``chunk`` steps (the
    policy's ring_k where it has a ring): greedy, or with ``sample`` and
    its ``noise`` source.

    device: cuda unless given; ``graph=True`` (the default) needs a CUDA
    device and replays each step from a CUDA graph, ``graph=False`` runs the
    same step eagerly. check_room=False leaves the room check to the
    caller. ``comm``: the tensor-parallel group of the step's
    all-reduces; such a step runs eagerly, as a gloo collective cannot be
    captured (``graph=True`` with a group raises)."""

    def __init__(self, cfg: ModelConfig, params: dict, policy, state, *,
                 chunk: int = 0, graph: bool = True, device=None,
                 sample=None, noise=None, check_room: bool = True,
                 comm=None):
        if graph and comm is not None:
            raise ValueError("a step with collectives is not captured: pass "
                             "graph=False under a process group")
        self.device = resolve_device(device)
        if graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device; pass "
                             "graph=False to decode eagerly")
        ring_k = (getattr(policy, "ring_k", 0)
                  if getattr(state, "ring_kv", None) is not None else 0)
        chunk = chunk or ring_k
        if chunk < 1 or (ring_k and chunk > ring_k):
            raise ValueError(f"chunk {chunk} must be in [1, ring_k = "
                             f"{ring_k}]" if ring_k else
                             f"chunk {chunk} must be at least 1")
        self.cfg, self.params, self.policy, self.state = (cfg, params, policy,
                                                          state)
        self.comm = comm
        self.chunk, self.ring = chunk, bool(ring_k)
        self.use_graph = graph
        self.graph = None
        self.capture_seconds = None
        self.pool_bytes = None      # device memory the capture reserved
        self.replays = 0
        self.check_room = check_room
        self.steps_left = policy.budget.max_new_tokens
        if (sample is None) != (noise is None):
            raise ValueError("a sampled decode needs both sample and noise")
        self.sample, self.noise = sample, noise
        B = state.pos.shape[0]
        i32 = dict(dtype=torch.int32, device=self.device)
        self.tok = torch.zeros(B, **i32)
        self.pos = torch.zeros(B, **i32)
        self.out = torch.zeros((chunk, B), **i32)
        self.row = torch.zeros(1, dtype=torch.long, device=self.device)
        self.gumbel = (torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                                   device=self.device)
                       if sample is not None else None)

    def _step(self) -> None:
        logits = llama.decode_step_batched(self.cfg, self.params, self.policy,
                                           self.state, self.tok, self.pos,
                                           self.comm)
        with stage("argmax"):
            nxt = (torch.argmax(logits, -1).to(torch.int32)
                   if self.sample is None else
                   self.sample(logits, self.gumbel))
            self.out.index_copy_(0, self.row, nxt[None])
            self.tok.copy_(nxt)
            self.pos += 1
            self.row += 1

    def _warm_up_and_capture(self) -> None:
        """Step once eagerly on a side stream (a real step), then capture
        the step on the same stream (the W8 kernel's scratch is per
        stream, made at the eager step); the capture runs nothing."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._step()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        cur.wait_stream(side)
        # the capture starts by emptying the allocator's cache: so does the
        # measurement of the pool it reserves
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self._step()
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph

    @torch.no_grad()
    def step(self, eager: bool = False) -> None:
        """One decode step of the chunk begun: replayed, captured first if
        need be, or eager (always with ``eager``: the captured step's
        launches op by op, which ``harness/trace.py`` profiles to name the
        kernels of a replay)."""
        self._check_room(1)
        if self.noise is not None:
            self.noise.fill_(self.gumbel)
        if eager or not self.use_graph:
            self._step()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            self.replays += 1
        self.steps_left -= 1

    def _check_room(self, n_steps: int) -> None:
        if self.check_room and n_steps > self.steps_left:
            raise ValueError(
                f"{n_steps} more steps exceed the state's room: the budget "
                f"reserved max_new_tokens = "
                f"{self.policy.budget.max_new_tokens}, {self.steps_left} left")

    def begin(self, tokens: torch.Tensor, pos: torch.Tensor) -> None:
        """Start a chunk from tokens and positions [B]."""
        self.tok.copy_(tokens)
        self.pos.copy_(pos)
        self.row.zero_()

    def finish(self, n_steps: int) -> torch.Tensor:
        """End a chunk of n_steps steps: flush the ring. Returns the
        chunk's tokens [n_steps, B]."""
        if self.ring:
            with stage("flush"):
                self.policy.flush_ring_batched(self.state)
        return self.out[:n_steps].clone()

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, pos: torch.Tensor,
               n_steps: int) -> torch.Tensor:
        """One chunk: n_steps tokens for every slot from tokens and
        positions [B]; the ring is flushed at the end. Returns [n_steps, B]
        int32 on the device; nothing waits for the card."""
        if not 1 <= n_steps <= self.chunk:
            raise ValueError(f"a chunk takes 1 to {self.chunk} steps, not "
                             f"{n_steps}")
        self._check_room(n_steps)
        self.begin(tokens, pos)
        for _ in range(n_steps):
            self.step()
        return self.finish(n_steps)

    def generate(self, tokens: torch.Tensor, pos: torch.Tensor,
                 n_steps: int) -> torch.Tensor:
        """n_steps tokens in chunks of ``chunk``, each chunk fed the last
        token of the one before. Returns [n_steps, B] int32."""
        out = []
        tok, p = tokens.to(torch.int32), pos.to(torch.int32)
        for i in range(0, n_steps, self.chunk):
            n = min(self.chunk, n_steps - i)
            out.append(self.decode(tok, p, n))
            tok, p = out[-1][-1], p + n
        return torch.cat(out)
