"""Round strategies of the port's simulator (counterpart of
``fedml_tpu/simulation/xla/algorithms.py``).

An algorithm is a strategy the round calls into:

* a per-step gradient hook (FedProx, SCAFFOLD, FedDyn) that both engines run
  after ``backward()`` and before the optimizer step;
* a per-client contribution, summed over the round's clients into ``ext``;
* a per-client output (a control-variate delta), stacked over the round's
  slots and scatter-added into a client-state table on the card;
* a server step on the round's weighted sum and ``ext``.

Each strategy's math is its JAX twin's, operation for operation where that
is cheap; the tests (``tests/test_torch_zoo.py``) hold the two to a stated
tolerance.  The tensor work is ``torch._foreach_*`` over the parameter list,
one launch a list.  Every host scalar (sample counts, step counts,
staleness) stays a Python or numpy number: no strategy reads the card.

With an attack or a defense on, the round's aggregation moves to the
security tail (``fed_sim._security_round``), which reads the round's stacked
client rows.  The strategies that aggregate through ``ext``
(``aggregates_via_acc`` False: FedNova, AsyncFedAvg, FedBuff) then rebuild
``ext`` from the attacked and defended rows (``ext_from_rows``), from a
per-client vector each gives (``security_meta``: FedNova's step counts, the
async strategies' staleness).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core.async_fl.staleness import _check_policy, staleness_weights
from ...ml.engine.train import GradHook, LocalTrainResult
from ...models.convert import is_batch_stat

Variables = Dict[str, torch.Tensor]


def params_of(variables: Variables) -> Variables:
    """The JAX package's ``variables["params"]``: the entries that the
    module's ``named_parameters()`` yields, without BatchNorm's running
    averages (flax's ``batch_stats``).  The server optimizers and SCAFFOLD's
    and FedDyn's corrections act on these alone; the averages are averaged
    with the sample weights, as every entry is."""
    return {k: v for k, v in variables.items() if not is_batch_stat(k)}


def _f32(tree: Variables, names: List[str]) -> List[torch.Tensor]:
    return [tree[k] if tree[k].dtype == torch.float32 else tree[k].float() for k in names]


def _zeros32(tree: Variables) -> Variables:
    return {k: torch.zeros_like(v, dtype=torch.float32) for k, v in tree.items()}


def _weighted_avg(acc: Variables, wsum: float, like: Variables) -> Variables:
    """acc is the fp32 weighted SUM of client variables; divide and restore
    each parameter's dtype."""
    return {k: (a / max(float(wsum), 1e-9)).to(like[k].dtype) for k, a in acc.items()}


def _cast_like(values: List[torch.Tensor], like: Variables, names: List[str]) -> Variables:
    return {k: v.to(like[k].dtype) for k, v in zip(names, values)}


def tree_add_(acc: Any, add: Any) -> Any:
    """``acc + add`` leaf by leaf, returned: a dict of tensors is added in
    place by one ``_foreach_add_``, host numbers by value."""
    if isinstance(acc, dict):
        if acc and all(torch.is_tensor(v) for v in acc.values()):
            torch._foreach_add_(list(acc.values()), [add[k] for k in acc])
            return acc
        return {k: tree_add_(v, add[k]) for k, v in acc.items()}
    return acc + add


def split_slots(cex: Any, slots: int) -> List[Any]:
    """The round's client extras (or output buffer), one entry a slot: each
    tensor unbound along its leading axis (views, one op a tensor a round),
    or a host array's elements; None gives None for every slot."""
    if cex is None:
        return [None] * slots
    if isinstance(cex, dict):
        rows = {k: v.unbind(0) for k, v in cex.items()}
        return [{k: r[s] for k, r in rows.items()} for s in range(slots)]
    return list(cex)


# A foreach op takes its fused (multi-tensor) path only where every pair of
# tensors has equal strides; one pair that differs sends the whole list to a
# loop of per-tensor ops.  So every [rows, ...] table and buffer lays each row
# out as the parameter it belongs to (``channels_last`` convolution weights).
def _empty_rows(rows: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised fp32 [rows, *like.shape] tensor whose rows have
    ``like``'s strides (``like`` is dense)."""
    return torch.empty_strided((rows,) + tuple(like.shape), (like.numel(),) + like.stride(),
                               dtype=torch.float32, device=like.device)


def out_buffer(algo: "InMeshAlgorithm", variables: Variables, slots: int) -> Optional[Variables]:
    """The round's per-slot output buffer, ``{name: [slots, ...]}`` fp32
    zeros (None when the algorithm has no per-client output)."""
    out_t = algo.out_template(variables)
    if out_t is None:
        return None
    return {k: _empty_rows(slots, t).zero_() for k, t in out_t.items()}


def store_out(out_row: Optional[Variables], out: Optional[Variables]) -> None:
    """Write one client's output into its slot's row of the round's buffer."""
    if out_row is not None:
        names = list(out_row)
        torch._foreach_copy_([out_row[k] for k in names], [out[k] for k in names])


class InMeshAlgorithm:
    """FedAvg, and the contract every strategy implements.

    Host-side methods (``init_*``, ``gather_client_extras``,
    ``apply_client_outs``, ``host_round_end``) run between rounds; the others
    inside the round.  ``cex`` is the round's client extras (leading axis =
    the round's slots), ``cex_i`` one slot of it (``split_slots``); ``w`` and
    ``real`` are host floats (the client's sample count, and whether it is
    a real client); ``result`` is the client's ``LocalTrainResult`` (the
    packed stream's carries no per-client loss: no strategy reads it)."""

    needs_client_state = False
    # True when server_update consumes the weighted variables sum ``acc``;
    # FedNova and the async strategies aggregate through ``ext`` instead
    aggregates_via_acc = True

    def __init__(self, args):
        self.args = args

    # -- engine plumbing ---------------------------------------------------
    def grad_hook(self) -> Optional[GradHook]:
        """Per-step hook for the engines (None = plain SGD; the engines then
        install FedProx's from ``args.proximal_mu``)."""
        return None

    def engine_extra(self, cex_i: Any, server_state: Any) -> Optional[Variables]:
        """The ``{name: tensor}`` extra handed to the grad hook for one
        client; the engines take it once per client."""
        return None

    # -- per-client reduction ----------------------------------------------
    def zero_contrib(self, variables: Variables) -> Any:
        return 0.0

    def client_contrib(self, variables, result: LocalTrainResult, w: float, real: float,
                       cex_i, server_state) -> Any:
        """Extra per-client contribution, summed into ``ext`` (the weighted
        variables sum is accumulated by the engines themselves)."""
        return 0.0

    def client_out(self, variables, result: LocalTrainResult, real: float, cex_i,
                   server_state) -> Optional[Variables]:
        """Per-client output, stacked over the round's slots (a control-
        variate delta to scatter into the client-state table)."""
        return None

    def client_result(self, variables, result, w, real, cex_i, server_state):
        """``(client_contrib, client_out)``; a strategy whose two are the same
        tensors computes them once."""
        return (self.client_contrib(variables, result, w, real, cex_i, server_state),
                self.client_out(variables, result, real, cex_i, server_state))

    def out_template(self, variables: Variables) -> Optional[Variables]:
        """Shape template of one client's ``client_out`` (None: no output)."""
        return None

    # -- the security tail ---------------------------------------------------
    def ext_from_rows(self, mat: torch.Tensor, w: torch.Tensor, w_orig: torch.Tensor,
                      meta: np.ndarray, g_vec: torch.Tensor, unravel) -> Any:
        """This strategy's ``ext`` rebuilt from the security tail's (attacked,
        defended) rows, in place of the round's in-stream contributions.

        ``mat``: [n, D] client rows (``ravel_pytree`` order); ``w``: [n]
        defended weights (a selection defense zeroes rows here); ``w_orig``:
        [n] the round's sample counts; ``meta``: [n] host numbers from
        ``security_meta``; ``g_vec``: the fp32 global as a row; ``unravel``:
        a row to a ``{name: fp32}`` dict.  Only strategies with
        ``aggregates_via_acc`` False need it."""
        raise NotImplementedError(
            f"{type(self).__name__} aggregates through ext (aggregates_via_acc=False) and "
            "must implement ext_from_rows to compose with attacks and defenses")

    def security_meta(self, taus: np.ndarray, cex: Any, real_sel: np.ndarray) -> np.ndarray:
        """[n_real] per-client host numbers for ``ext_from_rows``, sliced from
        the round's step counts (``taus``, by schedule slot) or client extras
        (``cex``)."""
        return np.zeros((len(real_sel),), np.float32)

    # -- server step -------------------------------------------------------
    def server_update(self, acc: Variables, wsum: float, ext, variables: Variables,
                      server_state) -> Tuple[Variables, Any]:
        return _weighted_avg(acc, wsum, variables), server_state

    # -- host side ---------------------------------------------------------
    def init_server_state(self, variables: Variables) -> Any:
        return ()

    def init_client_state(self, num_clients: int, variables: Variables) -> Optional[Variables]:
        return None

    def gather_client_extras(self, client_state, ids: np.ndarray, real: np.ndarray,
                             round_idx: int) -> Any:
        """Per-round per-client inputs, leading axis = len(ids)."""
        if client_state is None:
            return None
        idx = _index(ids, client_state)
        return {k: _empty_rows(len(ids), t[0]).copy_(t.index_select(0, idx))
                for k, t in client_state.items()}

    def apply_client_outs(self, client_state, ids: np.ndarray, outs):
        """Fold the round's stacked client outputs back into the state table.
        Outputs are DELTAS masked to zero for padded slots, so a scatter-add
        is safe even when the padding repeats a real client id."""
        if client_state is None:
            return None
        idx = _index(ids, client_state)
        for k, t in client_state.items():
            t.index_add_(0, idx, outs[k])
        return client_state

    def host_round_end(self, ids: np.ndarray, real: np.ndarray, round_idx: int) -> None:
        pass

    def host_state(self) -> Dict[str, Any]:
        """Host-side mutable state for checkpointing."""
        return {}

    def restore_host_state(self, state: Dict[str, Any]) -> None:
        pass


def _index(ids: np.ndarray, table: Variables) -> torch.Tensor:
    device = next(iter(table.values())).device
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _table(num_clients: int, variables: Variables) -> Variables:
    """A [num_clients, *shape] fp32 zero table for each parameter."""
    return {k: _empty_rows(num_clients, v).zero_() for k, v in params_of(variables).items()}


class FedAvgInMesh(InMeshAlgorithm):
    """Weighted averaging; FedProx rides this unchanged (the engines install
    the proximal grad hook from ``args.proximal_mu``)."""


class FedOptInMesh(InMeshAlgorithm):
    """Server-side adaptive optimization (Reddi et al.): the weighted-average
    delta is a pseudo-gradient for a server optimizer whose state is carried
    round to round."""

    def __init__(self, args):
        super().__init__(args)
        # imported here, as the JAX package does: fedopt_api holds the sp
        # FedOptAPI, whose FedAvgAPI imports the round simulator
        from ..sp.fedopt.fedopt_api import make_server_optimizer

        self._tx = make_server_optimizer(args)

    def init_server_state(self, variables):
        return self._tx.init(params_of(variables))

    def server_update(self, acc, wsum, ext, variables, server_state):
        avg = _weighted_avg(acc, wsum, variables)
        params = params_of(variables)
        names = list(params)
        pseudo_grad = dict(zip(names, torch._foreach_sub([params[k] for k in names],
                                                         [avg[k] for k in names])))
        updates, new_state = self._tx.update(pseudo_grad, server_state, params)
        new = torch._foreach_add([params[k] for k in names], [updates[k] for k in names])
        return {**avg, **_cast_like(new, params, names)}, new_state


class FedNovaInMesh(InMeshAlgorithm):
    """Normalized averaging (Wang et al.): w <- w - tau_eff * sum_i p_i d_i
    with d_i = (w - w_i)/tau_i, tau_eff = sum_i p_i tau_i, p_i = n_i / sum n.
    tau_i is the engine's step count (``LocalTrainResult.steps``)."""

    aggregates_via_acc = False

    def zero_contrib(self, variables):
        return {"d": _zeros32(variables), "tau": 0.0}

    def client_contrib(self, variables, result, w, real, cex_i, server_state):
        names = list(variables)
        d = torch._foreach_sub(_f32(variables, names), _f32(result.variables, names))
        torch._foreach_div_(d, max(result.steps, 1.0))
        torch._foreach_mul_(d, w)
        return {"d": dict(zip(names, d)), "tau": w * result.steps}

    def server_update(self, acc, wsum, ext, variables, server_state):
        names = list(variables)
        denom = max(float(wsum), 1e-9)
        step = torch._foreach_mul([ext["d"][k] for k in names], ext["tau"] / denom)
        torch._foreach_div_(step, denom)
        new = torch._foreach_sub(_f32(variables, names), step)
        return _cast_like(new, variables, names), server_state

    def security_meta(self, taus, cex, real_sel):
        # tau_i: the engine's per-client step count, captured with the row
        return np.asarray(taus, np.float32)[real_sel]

    def ext_from_rows(self, mat, w, w_orig, meta, g_vec, unravel):
        # client_contrib over rows: d = sum_i (w_i/tau_i)(g - m_i), tau =
        # sum_i w_i tau_i, with the DEFENDED weights, so a selection defense
        # drops a client from both the direction and tau_eff
        tau = torch.as_tensor(meta, dtype=torch.float32, device=mat.device)
        coef = w / torch.clamp_min(tau, 1.0)
        d_vec = torch.sum(coef) * g_vec - torch.matmul(coef, mat)
        return {"d": unravel(d_vec), "tau": float(torch.sum(w * tau))}


class ScaffoldInMesh(InMeshAlgorithm):
    """Stochastic controlled averaging (Karimireddy et al.).  Per-client
    control variates c_i live in a [N, *shape] table on the card, the server
    control c in the server state.  Local steps use g - c_i + c; after K
    steps c_i+ = c_i - c + (w - w_i)/(K lr) and c += (1/N) sum_i (c_i+ - c_i)."""

    needs_client_state = True

    def __init__(self, args):
        super().__init__(args)
        # c_i+ = c_i - c + (w - w_i)/(K lr) assumes each local step is exactly
        # p -= lr*g; with momentum/Adam the control variates would be wrong
        opt = str(getattr(args, "client_optimizer", "sgd")).lower()
        momentum = float(getattr(args, "momentum", 0.0) or 0.0)
        if opt != "sgd" or momentum > 0:
            raise NotImplementedError(
                "in-mesh SCAFFOLD requires client_optimizer='sgd' with zero "
                f"momentum (got {opt!r}, momentum={momentum})")
        self.lr = float(getattr(args, "learning_rate", 0.01))
        self.n_total = float(args.client_num_in_total)

    def grad_hook(self):
        def hook(grads, params, anchor, extra):
            torch._foreach_add_(grads, extra)

        return hook

    def engine_extra(self, cex_i, server_state):
        # c - c_i, folded once per client so that a step's hook is one add:
        # g + (c - c_i), where the JAX hook sums (g - c_i) + c (fp32 roundoff)
        names = list(server_state)
        return dict(zip(names, torch._foreach_sub([server_state[k] for k in names],
                                                  [cex_i[k] for k in names])))

    def init_server_state(self, variables):
        return _zeros32(params_of(variables))

    def init_client_state(self, num_clients, variables):
        return _table(num_clients, variables)

    def _dc(self, variables, result, real, cex_i, c):
        names = list(c)
        # K * lr in fp32, as the JAX package takes it
        k_lr = float(np.float32(max(result.steps, 1.0)) * np.float32(self.lr))
        ci = [cex_i[k] for k in names]
        new_ci = torch._foreach_sub(ci, [c[k] for k in names])
        drift = torch._foreach_sub(_f32(params_of(variables), names),
                                   _f32(params_of(result.variables), names))
        torch._foreach_div_(drift, k_lr)
        torch._foreach_add_(new_ci, drift)
        torch._foreach_sub_(new_ci, ci)
        torch._foreach_mul_(new_ci, real)
        return dict(zip(names, new_ci))

    def zero_contrib(self, variables):
        return self.init_server_state(variables)

    def out_template(self, variables):
        return params_of(variables)

    def client_contrib(self, variables, result, w, real, cex_i, server_state):
        return self._dc(variables, result, real, cex_i, server_state)

    def client_out(self, variables, result, real, cex_i, server_state):
        return self._dc(variables, result, real, cex_i, server_state)

    def client_result(self, variables, result, w, real, cex_i, server_state):
        dc = self._dc(variables, result, real, cex_i, server_state)
        return dc, dc

    def server_update(self, acc, wsum, ext, variables, server_state):
        names = list(server_state)
        new_c = torch._foreach_add([server_state[k] for k in names],
                                   torch._foreach_div([ext[k] for k in names], self.n_total))
        return _weighted_avg(acc, wsum, variables), dict(zip(names, new_c))


class FedDynInMesh(InMeshAlgorithm):
    """Dynamic regularization (Acar et al.).  Per-client h_i table and the
    running mean h in the server state; local grads use g - h_i + alpha (w -
    w_t); h_i+ = h_i - alpha (w_i - w_t); h <- h + (1/N) sum_i (h_i+ - h_i);
    w <- avg - h/alpha."""

    needs_client_state = True

    def __init__(self, args):
        super().__init__(args)
        self.alpha = float(getattr(args, "feddyn_alpha", 0.01))
        self.n_total = float(args.client_num_in_total)

    def grad_hook(self):
        alpha = self.alpha

        def hook(grads, params, anchor, extra):
            # g - h_i + alpha*p - alpha*a, in place (as FedProx's hook)
            torch._foreach_sub_(grads, extra)
            torch._foreach_add_(grads, params, alpha=alpha)
            torch._foreach_add_(grads, anchor, alpha=-alpha)

        return hook

    def engine_extra(self, cex_i, server_state):
        return cex_i

    def init_server_state(self, variables):
        return _zeros32(params_of(variables))

    def init_client_state(self, num_clients, variables):
        return _table(num_clients, variables)

    def _dh(self, variables, result, real):
        names = list(params_of(variables))
        dh = torch._foreach_sub(_f32(params_of(result.variables), names),
                                _f32(params_of(variables), names))
        torch._foreach_mul_(dh, -self.alpha * real)
        return dict(zip(names, dh))

    def zero_contrib(self, variables):
        return self.init_server_state(variables)

    def out_template(self, variables):
        return params_of(variables)

    def client_contrib(self, variables, result, w, real, cex_i, server_state):
        return self._dh(variables, result, real)

    def client_out(self, variables, result, real, cex_i, server_state):
        return self._dh(variables, result, real)

    def client_result(self, variables, result, w, real, cex_i, server_state):
        dh = self._dh(variables, result, real)
        return dh, dh

    def server_update(self, acc, wsum, ext, variables, server_state):
        avg = _weighted_avg(acc, wsum, variables)
        names = list(server_state)
        new_h = torch._foreach_add([server_state[k] for k in names],
                                   torch._foreach_div([ext[k] for k in names], self.n_total))
        params = torch._foreach_sub(_f32(params_of(avg), names),
                                    torch._foreach_div(new_h, self.alpha))
        return {**avg, **_cast_like(params, avg, names)}, dict(zip(names, new_h))


class AsyncFedAvgInMesh(InMeshAlgorithm):
    """Buffered asynchronous FedAvg (FedBuff-style, Nguyen et al.
    arXiv:2106.06639): each round is one buffer flush.  The sampled clients'
    deltas are mixed with staleness-discounted weights a_i = alpha / (1 +
    tau_i)^beta, tau_i = rounds since client i last participated, and w <- w
    + (1/K) sum_i a_i (w_i - w).  Clients train from the current model (the
    discount models staleness; the stale-weights effect is not simulated).
    Staleness and weights are host numbers."""

    aggregates_via_acc = False

    def __init__(self, args):
        super().__init__(args)
        self.alpha = float(getattr(args, "async_alpha", 0.6))
        self.beta = float(getattr(args, "async_beta", 0.5))
        self._last_round: Dict[int, int] = {}

    def gather_client_extras(self, client_state, ids, real, round_idx):
        return np.array([round_idx - self._last_round.get(int(c), round_idx) for c in ids],
                        np.float32)

    def host_round_end(self, ids, real, round_idx):
        for c, r in zip(ids, real):
            if r > 0:
                self._last_round[int(c)] = round_idx

    def host_state(self):
        return {"last_round": {str(k): v for k, v in self._last_round.items()}}

    def restore_host_state(self, state):
        self._last_round = {int(k): int(v) for k, v in state.get("last_round", {}).items()}

    def zero_contrib(self, variables):
        return {"d": _zeros32(variables), "k": 0.0}

    def client_contrib(self, variables, result, w, real, cex_i, server_state):
        # a_i in fp32, as the JAX package takes it
        a_i = np.float32(self.alpha) / (np.float32(1.0) + np.float32(cex_i)) ** np.float32(
            self.beta)
        names = list(variables)
        d = torch._foreach_sub(_f32(result.variables, names), _f32(variables, names))
        torch._foreach_mul_(d, float(a_i * np.float32(real)))
        return {"d": dict(zip(names, d)), "k": real}

    def server_update(self, acc, wsum, ext, variables, server_state):
        names = list(variables)
        step = torch._foreach_div([ext["d"][k] for k in names], max(ext["k"], 1.0))
        new = torch._foreach_add(_f32(variables, names), step)
        return _cast_like(new, variables, names), server_state

    def security_meta(self, taus, cex, real_sel):
        # staleness, gathered per slot by gather_client_extras
        return np.asarray(cex, np.float32)[real_sel]

    def ext_from_rows(self, mat, w, w_orig, meta, g_vec, unravel):
        # client_contrib ignores sample weights (each arrival mixes with its
        # own staleness discount a_i), so a defense enters as the relative
        # factor r_i = w_i / w_orig_i: 1 for row transforms, 0 or 1 for
        # selection defenses
        stale = torch.as_tensor(meta, dtype=torch.float32, device=mat.device)
        r = w / torch.clamp_min(w_orig, 1e-9)
        a_i = r * self.alpha / (1.0 + stale) ** self.beta
        d_vec = torch.matmul(a_i, mat) - torch.sum(a_i) * g_vec
        return {"d": unravel(d_vec), "k": float(torch.sum(r))}


class FedBuffInMesh(InMeshAlgorithm):
    """Buffered-async FedBuff flush (``fl_mode=async``): each round
    aggregates ONE buffer's worth of arrivals with weights ``n_i *
    staleness_weight(policy, s_i)``; the staleness values come from the
    simulator's virtual arrival queue (``set_staleness`` before each round).
    As with :class:`AsyncFedAvgInMesh`, clients train from the CURRENT
    global; with ``async_max_staleness == 0`` every arrival has staleness 0
    and the approximation is exact."""

    aggregates_via_acc = False

    def __init__(self, args):
        super().__init__(args)
        self.policy = str(getattr(args, "async_staleness_policy", "constant") or "constant")
        _check_policy(self.policy)
        self.s_alpha = float(getattr(args, "async_staleness_alpha", 0.5) or 0.5)
        self.hinge_b = int(getattr(args, "async_hinge_b", 4) or 4)
        self._staleness: Dict[int, float] = {}

    def set_staleness(self, mapping: Dict[int, float]) -> None:
        """Host hook: this flush's per-client staleness (clients
        absent from the map get 0)."""
        self._staleness = {int(k): float(v) for k, v in mapping.items()}

    def gather_client_extras(self, client_state, ids, real, round_idx):
        return np.array([self._staleness.get(int(c), 0.0) for c in ids], np.float32)

    def zero_contrib(self, variables):
        return {"num": _zeros32(variables), "den": 0.0}

    def client_contrib(self, variables, result, w, real, cex_i, server_state):
        wi = float(np.float32(w) * staleness_weights(
            self.policy, cex_i, alpha=self.s_alpha, hinge_b=self.hinge_b) * np.float32(real))
        names = list(variables)
        num = torch._foreach_mul(_f32(result.variables, names), wi)
        return {"num": dict(zip(names, num)), "den": wi}

    def server_update(self, acc, wsum, ext, variables, server_state):
        names = list(variables)
        new = torch._foreach_div([ext["num"][k] for k in names], max(ext["den"], 1e-9))
        return _cast_like(new, variables, names), server_state

    def security_meta(self, taus, cex, real_sel):
        # staleness, gathered per slot by gather_client_extras
        return np.asarray(cex, np.float32)[real_sel]

    def ext_from_rows(self, mat, w, w_orig, meta, g_vec, unravel):
        # the defended weights carry the sample counts (a selection defense
        # zeroes dropped rows); the staleness discount applies on top
        disc = staleness_weights(self.policy, meta, alpha=self.s_alpha, hinge_b=self.hinge_b)
        wi = w * torch.as_tensor(disc, dtype=torch.float32, device=mat.device)
        return {"num": unravel(torch.matmul(wi, mat)), "den": float(torch.sum(wi))}

    def host_state(self):
        return {"staleness": {str(k): v for k, v in self._staleness.items()}}

    def restore_host_state(self, state):
        self._staleness = {int(k): float(v) for k, v in state.get("staleness", {}).items()}


_REGISTRY = {
    "fedavg": FedAvgInMesh,
    "fedprox": FedAvgInMesh,  # the engines' grad hook from args.proximal_mu
    "fedsgd": FedAvgInMesh,  # E=1, full batch: configured via args
    # FedSeg is FedAvg round-wise: the per-pixel CE rides the ce loss and the
    # segmentation eval the aggregator's ModelTrainerSeg
    "fedseg": FedAvgInMesh,
    "fedopt": FedOptInMesh,
    "fednova": FedNovaInMesh,
    "scaffold": ScaffoldInMesh,
    "feddyn": FedDynInMesh,
    "async_fedavg": AsyncFedAvgInMesh,
}


def create_inmesh_algorithm(args) -> InMeshAlgorithm:
    opt = str(getattr(args, "federated_optimizer", "FedAvg")).lower()
    if str(getattr(args, "fl_mode", "sync") or "sync").lower() == "async":
        # buffered-async execution replaces the round loop (fed_sim's
        # virtual arrival queue); only FedAvg aggregation has an async twin
        if opt != "fedavg":
            raise ValueError(
                f"fl_mode=async supports federated_optimizer 'fedavg' only "
                f"in the XLA simulator (got {opt!r})")
        return FedBuffInMesh(args)
    cls = _REGISTRY.get(opt)
    if cls is None:
        # the members with a program of their own never get here:
        # SimulatorXLA builds it (simulation/simulator.py), as in JAX
        raise NotImplementedError(
            f"federated_optimizer {opt!r} has no in-mesh strategy; use the 'sp' "
            "backend (its host round loop supports the full zoo)")
    return cls(args)
