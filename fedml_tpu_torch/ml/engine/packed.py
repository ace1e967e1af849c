"""Packed ragged-client round of the port: counterpart of
``fedml_tpu/ml/engine/packed.py``.

The padded round trains every client to the global maximum client size;
with Dirichlet-skewed clients about half its steps are padding.  The packed
round lays the round out as ONE stream of batches instead:

* each client contributes ceil(n_i/B) batches per epoch (its own padding is
  at most B-1 samples), clients back to back in the schedule's order;
* the stream is walked step by step: an ordinary optimizer step each (with
  the algorithm's grad hook), and at each client BOUNDARY the client's
  parameters are added into the fp32 weighted sum, its contribution into
  ``ext``, its output into its slot, and the parameters, the BatchNorm
  buffers and the optimizer are reset to the round start.  On the trust
  path the boundary first noises the client's parameters (local DP) and,
  with an attack or a defense on, writes them into the client's row of the
  round's stack instead of the sum.

``PackedSchedule``, ``pack_round`` and ``s_max_for`` are verbatim copies
(numpy): the shuffles come from ``np.random.default_rng((seed, round, cid,
e))`` on the host, so the port trains on the same batches as the JAX package,
bit for bit.

The JAX package runs the stream as one compiled ``while_loop`` (or ``scan``)
per device.  Here it is an eager loop on one card, and every per-step scalar
the loop needs (boundary, weight, slot, the batch's valid count) is read from the
numpy schedule: the loop never waits for the card, and the round syncs once,
when its caller reads the result.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ...simulation.xla.algorithms import out_buffer, split_slots, store_out, tree_add_
from ...models.convert import FlatLayout
from .train import (LocalTrainResult, build_loss_fn, load_variables, make_optimizer,
                    module_state, param_list, post_train_generator, resolve_grad_hook,
                    seed_dropout)

Variables = Dict[str, torch.Tensor]


class PackedSchedule(NamedTuple):
    """Per-device packed batch stream (leading axis n_dev, then S_max)."""

    idx: np.ndarray       # [n_dev, S_max, B] int32 rows into x_all/y_all
    mask: np.ndarray      # [n_dev, S_max, B] f32 valid-sample mask
    boundary: np.ndarray  # [n_dev, S_max] f32 1.0 on a client's last step
    weight: np.ndarray    # [n_dev, S_max] f32 client sample count (at boundary)
    slot: np.ndarray      # [n_dev, S_max] i32 schedule-slot of the running client
    n_steps: np.ndarray   # [n_dev] i32 real steps this round


def pack_round(
    ids2d: np.ndarray,
    counts2d: np.ndarray,
    client_rows: Callable[[int], np.ndarray],
    batch_size: int,
    epochs: int,
    seed: int,
    round_idx: int,
    s_max: int,
) -> PackedSchedule:
    """Build the packed stream for one round.

    ``ids2d``/``counts2d``: [n_dev, slots] scheduled client ids and their
    real sample counts (0 = dummy slot).  ``client_rows(cid)`` returns the
    client's row indices into the global data arrays.  Slot numbering is
    DEVICE-LOCAL (the cex/outs arrays are sharded over the client axis, so
    each device sees its own [slots, ...] shard).
    """
    n_dev, slots = ids2d.shape
    B = batch_size
    idx = np.zeros((n_dev, s_max, B), np.int32)
    mask = np.zeros((n_dev, s_max, B), np.float32)
    boundary = np.zeros((n_dev, s_max), np.float32)
    weight = np.zeros((n_dev, s_max), np.float32)
    slot = np.zeros((n_dev, s_max), np.int32)
    n_steps = np.zeros((n_dev,), np.int32)
    for d in range(n_dev):
        cursor = 0
        for ls in range(slots):
            n_i = int(counts2d[d, ls])
            if n_i <= 0:
                continue
            cid = int(ids2d[d, ls])
            rows = np.asarray(client_rows(cid))[:n_i]
            steps_per_epoch = -(-n_i // B)
            total = steps_per_epoch * epochs
            if cursor + total > s_max:
                raise ValueError(
                    f"packed stream overflow: device {d} needs {cursor + total} "
                    f"steps > s_max {s_max}"
                )
            for e in range(epochs):
                rng = np.random.default_rng((seed, round_idx, cid, e))
                perm = rng.permutation(rows)
                padded = np.resize(perm, steps_per_epoch * B)
                m = np.zeros(steps_per_epoch * B, np.float32)
                m[:n_i] = 1.0
                sl = np.s_[cursor : cursor + steps_per_epoch]
                idx[d, sl] = padded.reshape(steps_per_epoch, B)
                mask[d, sl] = m.reshape(steps_per_epoch, B)
                slot[d, sl] = ls
                cursor += steps_per_epoch
            boundary[d, cursor - 1] = 1.0
            weight[d, cursor - 1] = float(n_i)
        n_steps[d] = cursor
    return PackedSchedule(idx, mask, boundary, weight, slot, n_steps)


def s_max_for(max_client_n: int, slots: int, batch_size: int, epochs: int) -> int:
    """Static worst-case stream length per device (buffer size only — the
    traced trip count is the real length)."""
    return slots * (-(-max_client_n // batch_size)) * epochs


def build_packed_device_fn(
    module: nn.Module,
    args,
    algo,
    loss: str = "ce",
    pregather: bool = False,
    stream: str = "while",
    post_train=None,
    capture_updates: bool = False,
) -> Callable[..., Tuple[Variables, float, torch.Tensor, float, Any, Any]]:
    """The one-card round body of ``algo`` (an ``InMeshAlgorithm``).

    Returns ``fn(variables, server_state, x_all, y_all, sched, cex, slots) ->
    (acc, wsum, lsum, cnt, ext, outs)``: ``sched`` is one device's
    ``PackedSchedule`` (numpy, device axis dropped) over the round's
    ``slots`` schedule slots and ``cex`` the round's client extras
    (``algo.gather_client_extras``, leading axis ``slots``);
    ``acc`` the fp32 sum of ``n_i * variables_i`` over the clients, ``wsum``
    the sum of ``n_i`` (a float), ``lsum`` the summed per-sample loss (a 0-d
    tensor on the card) and ``cnt`` the number of samples it sums (a float),
    over every epoch; ``ext`` the sum of ``algo.client_contrib`` and
    ``outs`` each slot's ``algo.client_out`` (``{name: [slots, ...]}``, or
    None when the strategy has no output).

    A client's variables are the module's parameters and buffers (the
    BatchNorm running averages, which each training forward moves): all of
    them enter the sums and the captured rows, and all are reset to the
    round start at its boundary.  A step whose batch is all padding takes no
    step and leaves them as they were (the JAX engine's where-masking); the
    stream ``pack_round`` lays out has none, each client's last batch holding
    its remainder.

    Per step, the grad hook (``algo.grad_hook()``, or FedProx's from
    ``args.proximal_mu``) rewrites the gradients before the optimizer step;
    its extra (``algo.engine_extra``) is taken once per client, at its first
    step.  A client's step count ``tau`` counts its steps whose mask holds a
    valid sample, read from the schedule.

    Dropout masks (``models/cnn.py``'s ``Dropout``) come from one generator
    a round, seeded (seed, round, ``DROPOUT_SALT``), drawn in stream order.

    ``post_train(variables, gen)`` rewrites a client's final variables at its
    boundary (local DP), drawing from ``post_train_generator((seed, round,
    client), device)`` with ``seed_round`` = (seed, round) given per call.
    ``capture_updates`` also writes each client's final fp32 variables into
    row ``slot`` of a ``[slots, D]`` matrix in ``ravel_pytree`` order and its
    step count into ``tau``; ``outs`` is then ``{"algo": outs, "update":
    matrix, "tau": [slots] numpy}``.  The weighted sum ``acc`` is kept either
    way: the security tail aggregates from the matrix, a round that only
    reads a row of it (an analysis attack) from ``acc``, as a clean round
    does.  With neither hook the boundary flush runs as it always has.

    ``stream`` ``"while"`` and ``"scan"`` run the same loop here.  In the JAX
    package scan also runs the bucket's tail past ``n_steps``, whose steps
    carry all-zero masks and change nothing, so on one card both compute the
    same thing.  ``pregather`` gathers the whole stream's rows with one
    ``index_select`` before the loop instead of one gather a step.
    """
    if stream not in ("while", "scan"):
        raise ValueError(f"xla_stream must be while|scan (got {stream!r})")
    make_opt = make_optimizer(args)
    loss_fn = build_loss_fn(module, loss)
    grad_hook = resolve_grad_hook(args, algo.grad_hook())
    names = [name for name, _ in module.named_parameters()]
    vnames = [name for name, _ in module_state(module)]  # parameters, then buffers

    def device_fn(variables: Variables, server_state, x_all: torch.Tensor,
                  y_all: torch.Tensor, sched: PackedSchedule, cex, slots: int,
                  seed_round: Tuple[int, int] = (0, 0), ids=None):
        dev = x_all.device
        n_steps = int(sched.n_steps)
        idx = torch.from_numpy(sched.idx[:n_steps].astype(np.int64)).to(dev)
        mask = torch.from_numpy(sched.mask[:n_steps]).to(dev)
        valid = sched.mask[:n_steps].sum(axis=1)  # host: each step's valid count
        if pregather:
            flat = idx.reshape(-1)
            bx_stream = x_all.index_select(0, flat).reshape(idx.shape + x_all.shape[1:])
            by_stream = y_all.index_select(0, flat).reshape(idx.shape + y_all.shape[1:])
        load_variables(module, variables)
        module.train()
        seed_dropout(module, seed_round, dev)
        params = list(module.parameters())
        state = [t for _, t in module_state(module)]  # params, then buffers
        params0, state0 = param_list(variables, names), param_list(variables, vnames)
        opt = make_opt(params)
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in variables.items()}
        acc_list = param_list(acc, vnames)
        if capture_updates:
            layout = FlatLayout.of(variables)
            update = torch.zeros((slots, layout.dim), dtype=torch.float32, device=dev)
            views = layout.views(update)  # {name: [slots, ...]}, each row its entry
            update_rows = [[views[k][s] for k in vnames] for s in range(slots)]
            taus = np.zeros((slots,), np.float32)
        ext = algo.zero_contrib(variables)
        outs = out_buffer(algo, variables, slots)
        cex_rows, out_rows = split_slots(cex, slots), split_slots(outs, slots)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        wsum = cnt = c_steps = c_cnt = 0.0
        for step in range(n_steps):
            if step == 0 or sched.boundary[step - 1] > 0:
                # a client's first step: its slot's extras, taken once
                s = int(sched.slot[step])
                cex_i = cex_rows[s]
                if grad_hook is not None:
                    with torch.no_grad():
                        extra = param_list(algo.engine_extra(cex_i, server_state), names)
            if valid[step] > 0:
                if pregather:
                    bx, by = bx_stream[step], by_stream[step]
                else:
                    bx = x_all.index_select(0, idx[step])
                    by = y_all.index_select(0, idx[step])
                step_loss = loss_fn(bx, by, mask[step])
                opt.zero_grad(set_to_none=True)
                step_loss.backward()
                if grad_hook is not None:
                    with torch.no_grad():
                        grad_hook([p.grad for p in params], params, params0, extra)
                opt.step()
                lsum.add_(step_loss.detach(), alpha=float(valid[step]))
                cnt += float(valid[step])
                c_cnt += float(valid[step])
                c_steps += 1.0
            if sched.boundary[step] > 0:
                # the client's last step: add w * its variables and its
                # contribution, store its output, then reset the variables
                # and the optimizer to the round start
                w = float(sched.weight[step])
                real = float(w > 0)
                final = dict(zip(vnames, state))
                with torch.no_grad():
                    if post_train is not None:
                        final = post_train(final, post_train_generator(
                            (*seed_round, int(ids[s])), dev))
                    result = LocalTrainResult(final, None, c_cnt, c_steps)
                    if capture_updates:
                        torch._foreach_copy_(update_rows[s], [final[k] for k in vnames])
                        taus[s] = c_steps
                    torch._foreach_add_(acc_list, [final[k].float() for k in vnames], alpha=w)
                    contrib, out = algo.client_result(variables, result, w, real, cex_i,
                                                      server_state)
                    ext = tree_add_(ext, contrib)
                    store_out(out_rows[s], out)
                    torch._foreach_copy_(state, state0)
                wsum += w
                opt = make_opt(params)
                c_steps = c_cnt = 0.0
        if capture_updates:
            outs = {"algo": outs, "update": update, "tau": taus}
        return acc, wsum, lsum, cnt, ext, outs

    return device_fn
