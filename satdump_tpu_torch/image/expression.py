"""Expression compositor: RGB composites from channel math.

Reference: src-core/image/expression.{h,cpp} evaluates a muparser expression
*per pixel* over the channel values (e.g. instrument cfg "ch2, ch2, ch1" or
"(ch2 - ch1) / (ch2 + ch1)"). Here the expression is parsed once (Python
ast, whitelisted nodes only — no eval()) and evaluated as whole-channel
float32 tensor ops on the device. Same expression strings as the
reference's instrument cfgs (resources/instrument_cfgs/*.json).

Arithmetic follows the JAX package's jitted evaluator: Python constants
stay Python floats until they meet a tensor (so they never promote float32
to float64), `%` and `**` and every function turn constants into float32,
comparisons give float32, and a division by a constant multiplies by its
float32 reciprocal, as XLA rewrites it. XLA also contracts a multiply and
an add into one FMA and uses its own sqrt/exp/log/sin/cos/tan/atan2/pow;
those can differ in the last bit here.
"""

from __future__ import annotations

import ast
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.utils.device import div, resolve_device, to_numpy

_F32 = torch.float32
_LOG10_INV = float(np.float32(0.4342944819032518))   # as jnp.log10


def _maximum(x, v: float):
    return torch.maximum(x, torch.tensor(v, dtype=_F32, device=x.device))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)      # jnp.clip's order


def _pow(a, b):
    # a constant exponent as a Python number: torch then squares or cubes
    # by multiplication, as XLA rewrites pow(x, 2) and pow(x, 3)
    if isinstance(a, torch.Tensor) and a.dim() and b.dim() == 0:
        return torch.pow(a, float(b))
    return torch.pow(a, b)


_ALLOWED_FUNCS = {
    "min": lambda *a: functools.reduce(torch.minimum, a),
    "max": lambda *a: functools.reduce(torch.maximum, a),
    "abs": torch.abs,
    "sqrt": lambda x: torch.sqrt(_maximum(x, 0.0)),
    "exp": torch.exp,
    "log": lambda x: torch.log(_maximum(x, 1e-12)),
    "log10": lambda x: torch.log(_maximum(x, 1e-12)) * _LOG10_INV,
    "pow": _pow,
    "clamp": _clip,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "atan2": torch.atan2,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "where": lambda c, a, b: torch.where(c != 0, a, b),
}


def _div(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a / b
    if isinstance(b, float) or b.dim() == 0:            # constant divisor
        recip = float(np.float32(1.0) / np.float32(float(b)))
        dev = a.device if isinstance(a, torch.Tensor) else b.device
        return _tensor(a, dev) * recip
    # a constant numerator as a tensor: torch's `number / tensor` would
    # multiply by the tensor's reciprocal
    return _tensor(a, b.device) / b


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: _div,
}
# jnp.mod / jnp.power make float32 arrays even of two constants
_TENSOR_BINOPS = {
    ast.Mod: torch.remainder,
    ast.Pow: _pow,
}

_CMPOPS = {
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
}


def _tensor(v, dev: torch.device):
    """A constant (Python float) as a float32 0-dim tensor."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=_F32, device=dev)


def _eval_node(node, env: Dict[str, torch.Tensor], dev: torch.device):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, env, dev)
    if isinstance(node, ast.Constant):
        if not isinstance(node.value, (int, float)):
            raise SatdumpError(f"expression: bad constant {node.value!r}")
        return float(node.value)
    if isinstance(node, ast.Name):
        if node.id not in env:
            raise SatdumpError(f"expression: unknown channel/var '{node.id}'")
        return env[node.id]
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_eval_node(node.left, env, dev),
                                      _eval_node(node.right, env, dev))
    if isinstance(node, ast.BinOp) and type(node.op) in _TENSOR_BINOPS:
        return _TENSOR_BINOPS[type(node.op)](
            _tensor(_eval_node(node.left, env, dev), dev),
            _tensor(_eval_node(node.right, env, dev), dev))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _eval_node(node.operand, env, dev)
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.Compare) and len(node.ops) == 1 \
            and type(node.ops[0]) in _CMPOPS:
        a = _eval_node(node.left, env, dev)
        b = _eval_node(node.comparators[0], env, dev)
        if isinstance(a, float) and isinstance(b, float):
            raise SatdumpError("expression: comparison of two constants")
        return _CMPOPS[type(node.ops[0])](a, b).to(_F32)
    if isinstance(node, ast.IfExp):
        c = _tensor(_eval_node(node.test, env, dev), dev)
        return torch.where(c if c.dtype == torch.bool else c != 0,
                           _tensor(_eval_node(node.body, env, dev), dev),
                           _tensor(_eval_node(node.orelse, env, dev), dev))
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _ALLOWED_FUNCS:
        args = [_tensor(_eval_node(a, env, dev), dev) for a in node.args]
        return _ALLOWED_FUNCS[node.func.id](*args)
    raise SatdumpError(f"expression: unsupported syntax {ast.dump(node)[:80]}")


def parse_expression(expr: str) -> List[ast.Expression]:
    """Split a composite expression into per-output-channel ASTs. The
    top-level comma (muparser convention, e.g. "ch2, ch2, ch1") separates
    output channels."""
    expr = expr.strip()
    tree = ast.parse(expr, mode="eval")
    if isinstance(tree.body, ast.Tuple):
        return [ast.Expression(body=e) for e in tree.body.elts]
    return [tree]


def compile_expression(expr: str, device: str | torch.device | None = None
                       ) -> Callable[[Dict[str, np.ndarray]], np.ndarray]:
    """expr + {channel name -> float array} -> (H, W) or (H, W, C) float32
    in [0,1], evaluated on `device` (default ``cuda``). Channel arrays must
    share a shape (apply ChannelTransform upstream)."""
    outs = parse_expression(expr)
    dev = resolve_device(device)

    def call(env: Dict[str, np.ndarray]) -> np.ndarray:
        return to_numpy(_run_trees(outs, _upload(env, dev), dev))

    return call


def _upload(env: Dict[str, np.ndarray], dev: torch.device
            ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev)
            if not isinstance(v, torch.Tensor) else v.to(dev, _F32)
            for k, v in env.items()}


def _bilinear(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def _used_names(trees) -> set:
    used = set()
    for t in trees:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                used.add(n.id)
    return used


def _resolve_cal_calls(trees, product, env) -> None:
    """Replace cal("<channel>", "<unit>", lo, hi) calls with env variables
    bound to the normalized calibrated channel (the compositor counterpart
    of the reference's cchN=(N, unit, min, max) syntax)."""
    from satdump_tpu_torch.products.calibration import calibrate_channel

    class T(ast.NodeTransformer):
        def visit_Call(self, node):
            self.generic_visit(node)
            if not (isinstance(node.func, ast.Name) and node.func.id == "cal"):
                return node
            args = [a.value for a in node.args
                    if isinstance(a, ast.Constant)]
            if len(args) != len(node.args) or len(args) not in (2, 4):
                raise SatdumpError("cal() wants (channel, unit[, lo, hi]) "
                                   "constants")
            name, unit = str(args[0]), str(args[1])
            key = f"_cal_{name}_{unit}_{len(env)}"
            v = np.asarray(calibrate_channel(product, name, unit),
                           np.float64)
            if len(args) == 4:
                lo, hi = float(args[2]), float(args[3])
                v = (v - lo) / max(hi - lo, 1e-12)
            env[key] = np.clip(np.nan_to_num(v), 0.0, 1.0
                               ).astype(np.float32)
            return ast.copy_location(ast.Name(id=key, ctx=ast.Load()), node)

    for i, t in enumerate(trees):
        trees[i] = ast.fix_missing_locations(T().visit(t))


def _channel_on_device(h, dev: torch.device) -> torch.Tensor:
    """A channel's counts normalized to [0,1] by its bit depth, converted
    on the device (uint16 travels as int32)."""
    img = np.asarray(h.image)
    if img.dtype == np.uint16:
        img = img.astype(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(img)).to(dev).to(_F32)
    return div(t, float((1 << h.bit_depth) - 1))


def generate_composite(product, expr: str, bit_depth: int = 8,
                       device: str | torch.device | None = None,
                       cache: Optional[Dict[str, torch.Tensor]] = None
                       ) -> np.ndarray:
    """ImageProduct + expression -> uint8/16 composite, evaluated on
    `device` (default ``cuda``). Channels are exposed as ch<NAME>
    normalized to [0,1] by their bit depth (the reference's convention for
    raw-count expressions); calibrated values via cal("<name>", "<unit>",
    lo, hi). Channels of different resolutions are resampled on the host
    onto the finest used grid through their ChannelTransforms (ref
    image::generate_composite channel_transform path). `cache` keeps the
    normalized channels on the device between composites of one product."""
    dev = resolve_device(device)
    trees = parse_expression(expr)
    env: Dict[str, np.ndarray | torch.Tensor] = {}
    _resolve_cal_calls(trees, product, env)
    used = _used_names(trees)

    holders = [h for h in product.images if f"ch{h.channel_name}" in used]
    target = max(holders, key=lambda h: h.image.size, default=None)
    for h in holders:
        key = f"ch{h.channel_name}"
        if target is not None and h.image.shape != target.image.shape:
            scale = float((1 << h.bit_depth) - 1)
            a = np.asarray(h.image, np.float32) / scale
            th, tw = target.image.shape
            X, Y = np.meshgrid(np.arange(tw, dtype=np.float64),
                               np.arange(th, dtype=np.float64))
            tt = getattr(target, "ch_transform", None)
            ct = getattr(h, "ch_transform", None)
            u, v = (tt.forward(X, Y) if tt is not None else (X, Y))
            x, y = (ct.reverse(u, v) if ct is not None else (u, v))
            # transforms both none (or identity): plain scale ratio
            if ct is None or (ct.type == 0 and (tt is None or tt.type == 0)):
                hh, hw = h.image.shape
                x = X * (hw / tw)
                y = Y * (hh / th)
            env[key] = _bilinear(a, x, y).astype(np.float32)
        elif cache is not None and key in cache:
            env[key] = cache[key]
        else:
            env[key] = _channel_on_device(h, dev)
            if cache is not None:
                cache[key] = env[key]

    out = _run_trees(trees, _upload(env, dev), dev)
    if bit_depth == 8:
        return to_numpy((out * 255.0 + 0.5).to(torch.uint8))
    return to_numpy((out * 65535.0 + 0.5).to(torch.int32)).astype(np.uint16)


def _run_trees(trees, env: Dict[str, torch.Tensor], dev: torch.device
               ) -> torch.Tensor:
    first = next(iter(env.values()))
    chans = [torch.as_tensor(_eval_node(t, env, dev), dtype=_F32, device=dev)
             + torch.zeros_like(first) for t in trees]
    img = chans[0] if len(chans) == 1 else torch.stack(chans, dim=-1)
    return torch.clamp(img, 0.0, 1.0)
