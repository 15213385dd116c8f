"""The sharding plan: a spec for every parameter, batch and cache leaf of an
LM over a :class:`~repro_torch.launch.mesh.Mesh`, with a per-dim
divisibility fallback. The reference's rules, over the port's names and its
per-layer (unstacked) tensors:

  * "in" matrices  (D, X)  — wq wk wv w_gate w_up w_in router w_dkv sh_* w_a
    w_x lm_head:            (fsdp, tp)
  * "out" matrices (X, D)  — wo w_out w_down sh_down w_uk w_uv: (tp, fsdp)
  * embedding (V, D):       (tp, fsdp)   (vocab on the tensor axis)
  * expert tensors (E, D, F) / (E, F, D): experts on tp, D on fsdp
  * 1-D biases (X,):        (tp,);  norms and scalars: replicated
  * conv (K, C):            (None, tp)

``fsdp`` is the data axes (ZeRO-style storage over the data rows); a dim
that its axes do not divide is replicated instead, and the plan records it
in ``fallbacks`` under the reference's label. The reference stacks the
layers of a scanned group along a leading axis and gives it a leading
``None``; a port tensor is one layer's, so its spec is the reference's core
spec (``convert.lm_params_from_numpy`` copies without transposing).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a tuple
of names (the data axes). Batch: the leading dim over the data axes. Caches:
the batch dim over the data axes; the KV-head dim on tp when it divides,
else ``head_dim``, else the sequence (MQA and long contexts keep the cache
distributed).
"""

from __future__ import annotations

import dataclasses

from torch import nn

from ..models.layers.common import ShardCtx

__all__ = ["Plan", "make_plan"]

_IN_MATS = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "router", "w_dkv",
    "sh_gate", "sh_up", "w_a", "w_x", "lm_head",
}
_OUT_MATS = {"wo", "w_out", "w_down", "sh_down", "w_uk", "w_uv"}
_REPLICATED_1D = {"norm1", "norm2", "norm_x", "final_norm", "enc_norm", "kv_norm", "gate_norm",
                  "lam", "A_log", "D", "dt_bias", "b_a", "b_x"}


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _shapes(tree) -> dict:
    """``{name: shape}`` of a module's parameters or a dict of tensors/arrays."""
    items = tree.named_parameters() if isinstance(tree, nn.Module) else tree.items()
    return {n: tuple(t.shape) for n, t in items}


@dataclasses.dataclass
class Plan:
    mesh: object
    dp: tuple[str, ...]
    tp: str
    fallbacks: list[str] = dataclasses.field(default_factory=list)
    # serve mode: inference-only weights drop the FSDP dim (dp -> replicated)
    serve: bool = False

    # -- helpers -----------------------------------------------------------
    def _size(self, axes) -> int:
        if axes is None:
            return 1
        axes = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def _fit(self, dim: int, axes, leaf: str, dim_idx: int):
        if axes is None:
            return None
        if dim % self._size(axes) == 0:
            return axes
        self.fallbacks.append(f"{leaf}[dim{dim_idx}]={dim} !% {axes}")
        return None

    def ctx(self) -> ShardCtx:
        return ShardCtx(mesh=self.mesh, dp=self.dp, tp=self.tp)

    def replicated(self) -> tuple:
        return ()

    # -- parameters --------------------------------------------------------
    def param_spec(self, name: str, shape) -> tuple:
        """The spec of the port's parameter ``name`` of ``shape``."""
        spec = self._param_core_spec(_leaf(name), tuple(shape))
        if self.serve:
            spec = tuple(None if s == self.dp else s for s in spec)
        return spec

    def _param_core_spec(self, name: str, shape: tuple) -> tuple:
        nd = len(shape)
        if nd == 0:
            return ()
        if nd == 1:
            if name in _REPLICATED_1D:
                return (None,)
            return (self._fit(shape[0], self.tp, name, 0),)
        if nd == 2:
            if name == "conv_w":  # (K, C)
                return (None, self._fit(shape[1], self.tp, name, 1))
            if name == "embedding" or name in _OUT_MATS:  # (V, D) / (X, D)
                return (self._fit(shape[0], self.tp, name, 0),
                        self._fit(shape[1], self.dp, name, 1))
            # the default "in" matrix (D, X)
            return (self._fit(shape[0], self.dp, name, 0), self._fit(shape[1], self.tp, name, 1))
        if nd == 3:  # experts (E, D, F) or (E, F, D)
            if name in _OUT_MATS:
                return (self._fit(shape[0], self.tp, name, 0), None,
                        self._fit(shape[2], self.dp, name, 2))
            return (self._fit(shape[0], self.tp, name, 0), self._fit(shape[1], self.dp, name, 1),
                    None)
        return (None,) * nd

    def param_shardings(self, params) -> dict:
        """``{name: spec}`` of a network (meta or not) or a dict of tensors."""
        return {n: self.param_spec(n, s) for n, s in _shapes(params).items()}

    # -- batches -----------------------------------------------------------
    def batch_spec(self, name: str, shape) -> tuple:
        return (self._fit(shape[0], self.dp, _leaf(name), 0),) + (None,) * (len(shape) - 1)

    def batch_shardings(self, batch: dict) -> dict:
        return {n: self.batch_spec(n, s) for n, s in _shapes(batch).items()}

    # -- caches ------------------------------------------------------------
    def cache_spec(self, name: str, shape) -> tuple:
        """The spec of one layer's cache leaf ``name`` (``k``, ``v``,
        ``c_kv``, ``k_rope``, ``state``, ``h``, ``conv``)."""
        core, tp = tuple(shape), self._size(self.tp)
        if name in ("k", "v"):  # (B, L, KV, hd)
            b, L, kv, hd = core
            spec = [self._fit(b, self.dp, name, 0), None, None, None]
            if kv % tp == 0:
                spec[2] = self.tp
            elif hd % tp == 0:
                spec[3] = self.tp
            elif L % tp == 0:
                spec[1] = self.tp  # sequence-sharded KV (MQA / long context)
        elif name in ("c_kv", "k_rope"):  # (B, L, R)
            b, L, r = core
            spec = [self._fit(b, self.dp, name, 0), None, self._fit(r, self.tp, name, 2)]
            if spec[2] is None and L % tp == 0:
                spec[1] = self.tp
        elif name == "state":  # ssd (B, H, P, N)
            b, h, _, _ = core
            spec = [self._fit(b, self.dp, name, 0), self._fit(h, self.tp, name, 1), None, None]
        elif name == "h":  # rglru (B, R)
            b, r = core
            spec = [self._fit(b, self.dp, name, 0), self._fit(r, self.tp, name, 1)]
        elif name == "conv":  # (B, K-1, C)
            b, _, c = core
            spec = [self._fit(b, self.dp, name, 0), None, self._fit(c, self.tp, name, 2)]
        else:
            spec = [self._fit(core[0], self.dp, name, 0)] + [None] * (len(core) - 1)
        return tuple(spec)

    def cache_shardings(self, cache):
        """Specs in the cache's own structure: a list of per-layer dicts, or
        the encoder-decoder's ``{"self": [...], "cross": [...]}``."""
        if isinstance(cache, dict) and not any(hasattr(v, "shape") for v in cache.values()):
            return {part: self.cache_shardings(layers) for part, layers in cache.items()}
        return [{k: self.cache_spec(k, v.shape) for k, v in layer.items()} for layer in cache]


def make_plan(mesh, serve: bool = False) -> Plan:
    """The plan over ``mesh``'s axes ``((pod,) data, model)``: the data axes
    are every axis but ``model``."""
    names = mesh.axis_names
    if "model" not in names:
        raise ValueError(f"mesh must have a 'model' axis, got {names}")
    dp = tuple(a for a in names if a != "model")
    return Plan(mesh=mesh, dp=dp, tp="model", serve=serve)
