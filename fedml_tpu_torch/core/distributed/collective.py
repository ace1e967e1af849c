"""Host-plane process-group collectives over TCP (counterpart of
``fedml_tpu/core/distributed/collective.py``).

A star topology over persistent TCP sockets, rank 0 the hub: rendezvous,
broadcast, gather, allgather, allreduce (sum and weighted mean) and barrier
over trees (nested dicts, lists and tuples) whose leaves are tensors, numpy
arrays or Python numbers.  It moves model-sized blobs between processes once
a round; gradient collectives inside a step are not its job.

The wire is the JAX package's, frame for frame, so a JAX rank and a port
rank can share a group:

* a joining rank first sends a fixed-format preamble (``[u16 token length]
  [token utf-8][i32 rank]``) that the hub checks before it unpickles
  anything from that connection;
* every later frame is a u64 big-endian length, then a pickle of a tree of
  numpy arrays.  ``_to_host`` turns each leaf into one, as the JAX package's
  ``np.asarray`` does (a tensor by ``.detach().cpu().numpy()``; a bf16 tensor,
  which has no numpy dtype, is refused);
* the hub reduces with the JAX package's numpy arithmetic: the sum is
  ``np.sum(np.stack(xs, 0), axis=0)``, the weighted mean ``sum(x * w) /
  den`` with the weights as 0-d float64 arrays and ``den`` 1.0 when it is
  not positive.  A port hub and a JAX hub give the same bits.

What a port rank receives, or reduces as the hub, comes back as tensors on
the group's ``device``; a rank's own tree comes back as it was passed.  All
ops are collective: every rank calls them in the same order.  Collective
waits use ``op_timeout``, large but finite, so a dead peer fails the group
instead of hanging it.
"""

from __future__ import annotations

import logging
import pickle
import socket
import struct
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

Tree = Any


def _send_frame(sock: socket.socket, obj: Any) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack(">Q", len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


def _join_preamble(token: Optional[str], rank: int) -> bytes:
    """The fixed-format join: [u16 token_len][token utf-8][i32 rank], read and
    checked without pickle, so an unauthenticated peer never reaches
    ``pickle.loads``."""
    tok = (token or "").encode("utf-8")
    if len(tok) > 256:
        raise ValueError("pg token too long (max 256 utf-8 bytes)")
    return struct.pack(">H", len(tok)) + tok + struct.pack(">i", rank)


def _recv_join(sock: socket.socket, token: Optional[str]) -> int:
    """Read and check a join preamble; raises on a token mismatch.  Returns
    the peer's rank.  No pickle is involved."""
    (tok_len,) = struct.unpack(">H", _recv_exact(sock, 2))
    if tok_len > 256:
        raise ValueError("oversized join token")
    tok = _recv_exact(sock, tok_len).decode("utf-8", errors="replace")
    if tok != (token or ""):
        raise ValueError("bad join token")
    (rank,) = struct.unpack(">i", _recv_exact(sock, 4))
    return rank


def _tree_map(fn: Callable, *trees: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure (dicts, lists, tuples;
    None is an empty node, as in a JAX pytree)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _host_leaf(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError("a bf16 tensor has no numpy dtype and cannot go on the process "
                            "group's wire; cast it to float32 first")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_host(tree: Tree) -> Tree:
    """Every leaf a numpy array before pickling (sockets move host memory)."""
    return _tree_map(_host_leaf, tree)


class ProcessGroup:
    """A star-topology process group; rank 0 is the hub.

    >>> pg = ProcessGroup(rank, world_size, addr=("127.0.0.1", 29500))
    >>> tree = pg.broadcast(tree)          # src=0 by default
    >>> mean = pg.allreduce_mean(params, weight=n)
    """

    def __init__(self, rank: int, world_size: int, addr=("127.0.0.1", 29500),
                 timeout: float = 60.0, token: Optional[str] = None,
                 op_timeout: float = 1800.0, device=None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.addr = (addr[0], int(addr[1]))
        self.timeout = float(timeout)
        self.token = token
        # collective waits: far longer than the rendezvous window, but finite
        # so a dead peer raises socket.timeout instead of hanging every rank
        self.op_timeout = float(op_timeout)
        self.device = torch.device(device if device is not None else "cpu")
        self._peers: List[Optional[socket.socket]] = [None] * self.world_size
        self._server: Optional[socket.socket] = None
        if self.world_size > 1:
            self._rendezvous()

    # -- bootstrap -----------------------------------------------------------
    def _rendezvous(self) -> None:
        if self.rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(self.addr)
            srv.listen(self.world_size)
            srv.settimeout(self.timeout)
            self._server = srv
            deadline = time.time() + self.timeout
            joined = 0
            while joined < self.world_size - 1:
                timed_out = ConnectionError(
                    f"hub: rendezvous timed out with {joined} of {self.world_size - 1} "
                    "peers joined")
                if time.time() > deadline:
                    raise timed_out
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    raise timed_out from None
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(self.timeout)
                try:
                    peer_rank = _recv_join(conn, self.token)
                    if (not 0 < peer_rank < self.world_size
                            or self._peers[peer_rank] is not None):
                        raise ValueError(f"bad join from rank {peer_rank}")
                except (OSError, ValueError, struct.error):
                    logger.warning("pg hub: rejected a join attempt", exc_info=True)
                    conn.close()
                    continue
                conn.settimeout(self.op_timeout)
                self._peers[peer_rank] = conn
                joined += 1
            logger.info("pg hub up: %d peers joined", self.world_size - 1)
            return
        deadline = time.time() + self.timeout
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            try:
                s = socket.create_connection(self.addr, timeout=self.timeout)
            except OSError as e:  # hub not up yet: retry
                last_err = e
                time.sleep(0.1)
                continue
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_join_preamble(self.token, self.rank))
            s.settimeout(self.op_timeout)
            self._peers[0] = s
            return
        raise ConnectionError(f"rank {self.rank}: rendezvous timed out: {last_err}")

    def _from_host(self, tree: Tree) -> Tree:
        """Received or reduced leaves as tensors on the group's device."""
        return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(self.device), tree)

    # -- collectives ---------------------------------------------------------
    def _broadcast(self, tree: Tree, src: int) -> Tree:
        """src's tree on every rank: as passed on src, as received elsewhere."""
        if src != 0:
            # routed through the hub: src uploads, the hub rebroadcasts
            if self.rank == src:
                _send_frame(self._peers[0], _to_host(tree))
                return tree
            if self.rank == 0:
                tree = _recv_frame(self._peers[src])
        if self.rank == 0:
            payload = _to_host(tree)
            for r, sock in enumerate(self._peers):
                if sock is not None and r != src:
                    _send_frame(sock, payload)
            return tree
        if self.rank == src:
            return tree
        return _recv_frame(self._peers[0])

    def broadcast(self, tree: Tree = None, src: int = 0) -> Tree:
        """Every rank returns src's tree.  Non-src ranks may pass None."""
        if self.world_size == 1:
            return tree
        out = self._broadcast(tree, src)
        return out if self.rank == src else self._from_host(out)

    def _gather(self, tree: Tree, dst: int) -> Optional[List[Tree]]:
        if self.rank == 0:
            out: List[Tree] = [None] * self.world_size
            out[0] = _to_host(tree)
            for r, sock in enumerate(self._peers):
                if sock is not None:
                    out[r] = _recv_frame(sock)
            if dst == 0:
                return out
            _send_frame(self._peers[dst], out)
            return None
        _send_frame(self._peers[0], _to_host(tree))
        if self.rank == dst:
            return _recv_frame(self._peers[0])
        return None

    def gather(self, tree: Tree, dst: int = 0) -> Optional[List[Tree]]:
        """dst returns [tree_rank0, ..., tree_rankN-1]; the others None."""
        if self.world_size == 1:
            return [tree]
        out = self._gather(tree, dst)
        return None if out is None else self._from_host(out)

    def allgather(self, tree: Tree) -> List[Tree]:
        if self.world_size == 1:
            return [tree]
        return self._from_host(self._broadcast(self._gather(tree, 0), 0))

    def allreduce_sum(self, tree: Tree) -> Tree:
        """Elementwise tree sum across ranks (reduce to the hub, rebroadcast)."""
        if self.world_size == 1:
            return tree
        gathered = self._gather(tree, 0)
        reduced = None
        if self.rank == 0:
            reduced = _tree_map(lambda *xs: np.sum(np.stack(xs, 0), axis=0), *gathered)
        return self._from_host(self._broadcast(reduced, 0))

    def allreduce_mean(self, tree: Tree, weight: float = 1.0) -> Tree:
        """Weighted mean sum(w_i x_i) / sum(w_i) across ranks.  The weight
        rides the tree's gather: one gather and one broadcast in all."""
        if self.world_size == 1:
            return tree
        gathered = self._gather((_to_host(tree), float(weight)), 0)
        reduced = None
        if self.rank == 0:
            trees = [t for t, _ in gathered]
            ws = [w for _, w in gathered]
            den = sum(ws)
            den = den if den > 0 else 1.0
            reduced = _tree_map(lambda *xs: sum(x * w for x, w in zip(xs, ws)) / den, *trees)
        return self._from_host(self._broadcast(reduced, 0))

    def barrier(self) -> None:
        self.allgather(np.zeros(()))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        for sock in self._peers:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass

    def __enter__(self) -> "ProcessGroup":
        return self

    def __exit__(self, *_) -> None:
        self.close()
