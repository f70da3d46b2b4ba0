"""ZeRO-1: the AdamW moments sharded over the data-parallel group.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/parallel/zero.py``
(``:40-98``), where sharding annotations let XLA shard each moment tensor
over the ``'data'`` axis. Here the parameters are laid end to end in one
flat vector cut into equal contiguous shards, one a rank (the last padded
with zeros), and each rank keeps the AdamW moments of its shard alone:
about 1/N of the optimizer bytes. A step (`ZeroOptimizer._step`) takes the
gradients already summed over the group (`train.loop.TrainStep.gradients`)
and already clipped by their global norm, which every rank computed alike;
each rank runs AdamW on its shard, and one all-gather of the updated shards
leaves every rank with identical parameters. The element-wise arithmetic is
`torch.optim.AdamW`'s on the same values, so the parameters equal plain data
parallelism's.

A msgpack checkpoint holds the full moments in the JAX layout: `gathered`
all-gathers them into a plain `Optimizer` that
`utils.convert.opt_state_to_jax` reads, and `load_gathered` takes a rank's
shard back from one that `opt_state_from_jax` filled. A directory checkpoint
(``orbax``, ``orbax_async``; `train.checkpoint`) gathers nothing, as JAX's
orbax writes each process's shards: `shard_moments` gives the rank's flat
slice ``[lo, hi)`` to write, and `load_shard` takes the slice of the current
world, which `train.checkpoint.read_moments` cuts from whatever world wrote
the files.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..train.loop import Optimizer


class ZeroOptimizer(Optimizer):
    """`train.loop.Optimizer` (clip, AdamW, gradient accumulation) with the
    AdamW moments sharded over `group`."""

    def __init__(self, train_spec, compat, steps_per_epoch: int = 1, group=None):
        super().__init__(train_spec, compat, steps_per_epoch)
        self.group = group

    def init(self, params) -> "ZeroOptimizer":
        self.params = list(params)
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) != 1:
            raise ValueError(f"ZeRO shards one flat vector of the parameters: they have dtypes {sorted(map(str, dtypes))}")
        world, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        total = sum(p.numel() for p in self.params)
        self.shard_numel = -(-total // world)
        self.lo = min(rank * self.shard_numel, total)
        self.hi = min(self.lo + self.shard_numel, total)
        first = self.params[0]
        # this rank's slice of the flat parameters, the one tensor AdamW steps
        self.shard = torch.zeros(self.shard_numel, dtype=first.dtype, device=first.device)
        self.adamw = torch.optim.AdamW([self.shard], lr=self.lr_at(0), **self._adamw_args)
        return self

    def _flat_slice(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's shard of the flat concatenation of `tensors`, padded
        with zeros to the shard's size."""
        out = torch.zeros_like(self.shard)
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        out[: self.hi - self.lo] = flat[self.lo:self.hi]
        return out

    def _gather(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's `shard` laid end to end, cut back into the
        parameters' shapes."""
        full = torch.empty(self.shard_numel * dist.get_world_size(self.group), dtype=shard.dtype,
                           device=shard.device)
        dist.all_gather_into_tensor(full, shard.contiguous(), group=self.group)
        sizes = [p.numel() for p in self.params]
        parts = full[: sum(sizes)].split(sizes)
        return [part.view(p.shape) for part, p in zip(parts, self.params)]

    def _step(self, grads: List[torch.Tensor]) -> None:
        with torch.no_grad():
            # the parameters may have been loaded since the last step
            self.shard.copy_(self._flat_slice(self.params))
            self.shard.grad = self._flat_slice(grads)
            for group in self.adamw.param_groups:
                group["lr"] = self.lr_at(self.updates)
            self.adamw.step()
            self.shard.grad = None
            for p, new in zip(self.params, self._gather(self.shard)):
                p.copy_(new)

    def moment_bytes(self) -> int:
        """The bytes of the AdamW moments this rank keeps."""
        state = self.adamw.state.get(self.shard, {})
        return sum(state[k].numel() * state[k].element_size() for k in ("exp_avg", "exp_avg_sq") if k in state)

    def gathered(self) -> Optimizer:
        """A plain `Optimizer` over the same parameters with every rank's
        moments gathered (a collective: every rank calls it), the counts and
        the accumulated gradients; for the checkpoint."""
        full = Optimizer(*self.spec).init(self.params)
        full.updates, full.mini_step, full._acc = self.updates, self.mini_step, self._acc
        state = self.adamw.state.get(self.shard)
        if state:
            mu, nu = self._gather(state["exp_avg"]), self._gather(state["exp_avg_sq"])
            for p, m, v in zip(self.params, mu, nu):
                full.adamw.state[p] = {"step": state["step"].clone(), "exp_avg": m, "exp_avg_sq": v}
        return full

    def load_gathered(self, full: Optimizer) -> None:
        """Take this rank's shard of a plain `Optimizer`'s moments and its
        counts (the inverse of `gathered`)."""
        self.updates, self.mini_step, self._acc = full.updates, full.mini_step, full._acc
        states = [full.adamw.state.get(p) for p in self.params]
        self.adamw.state.clear()
        if all(states):
            self.adamw.state[self.shard] = {
                "step": states[0]["step"].clone(),
                "exp_avg": self._flat_slice([s["exp_avg"] for s in states]),
                "exp_avg_sq": self._flat_slice([s["exp_avg_sq"] for s in states]),
            }

    def shard_moments(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's flat ``exp_avg`` and ``exp_avg_sq`` of ``[lo, hi)``
        (views, without the padding; zeros before the first update)."""
        state = self.adamw.state.get(self.shard)
        n = self.hi - self.lo
        if not state:
            zeros = self.shard.new_zeros(n)
            return zeros, zeros
        return state["exp_avg"][:n], state["exp_avg_sq"][:n]

    def load_shard(self, counts: Optimizer, exp_avg: np.ndarray, exp_avg_sq: np.ndarray) -> None:
        """Take the counts and accumulated gradients of `counts` (a plain
        `Optimizer` that `opt_state_from_jax` filled without moments) and
        this rank's slice ``[lo, hi)`` of the flat moments."""
        self.updates, self.mini_step, self._acc = counts.updates, counts.mini_step, counts._acc

        def padded(flat: np.ndarray) -> torch.Tensor:
            out = torch.zeros_like(self.shard)
            out[: self.hi - self.lo] = torch.from_numpy(np.ascontiguousarray(flat)).to(out)
            return out

        # as `opt_state_from_jax` keeps AdamW's step: on the host, the default float type
        step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
        self.adamw.state.clear()
        self.adamw.state[self.shard] = {"step": torch.tensor(float(self.updates), dtype=step_dtype),
                                        "exp_avg": padded(exp_avg), "exp_avg_sq": padded(exp_avg_sq)}
