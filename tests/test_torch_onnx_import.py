"""The port's ``.onnx`` reader and its two routes onto ``ConvTDFNetTrim``
against the JAX package's ``compat/onnx_import.py``, on files written by a
copy of tests/test_compat_tools.py's protobuf writer: a graph's
initializers and nodes, torch-named initializers (the name route) and
anonymous ones in trace order (the structural route, with norms as
Mul/Add or as BatchNormalization). Every tensor must be equal."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import finit, no_compile_cache_writes  # noqa: F401
from rvc_tpu.compat import onnx_import as jonnx
from rvc_tpu.models.mdx_net import ConvTDFNetTrim as JConvTDF
from rvc_tpu_torch.compat import onnx_import as tonnx
from rvc_tpu_torch.compat.weights import convtdf_state_dict
from rvc_tpu_torch.models.mdx_net import ConvTDFNetTrim
from test_torch_separation import lively

TINY = dict(num_blocks=5, l=1, g=4, bn=2, dim_f=16, act="relu")  # test_compat_tools.py's


def _onnx_writer_helpers():
    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    def field(num, wire, payload):
        key = varint((num << 3) | wire)
        if wire == 2:
            return key + varint(len(payload)) + payload
        return key + payload

    def tensor(name, arr):
        buf = b"".join(field(1, 0, varint(d)) for d in arr.shape)
        buf += field(2, 0, varint(1))  # float32
        buf += field(8, 2, name.encode())
        buf += field(9, 2, np.ascontiguousarray(arr, np.float32).tobytes())
        return field(5, 2, buf)

    def node(op, inputs, outputs):
        buf = b"".join(field(1, 2, i.encode()) for i in inputs)
        buf += b"".join(field(2, 2, o.encode()) for o in outputs)
        buf += field(4, 2, op.encode())
        return field(1, 2, buf)

    return varint, field, tensor, node


_, FIELD, TENSOR, NODE = _onnx_writer_helpers()


def _jax_params(norm: str, seed: int):
    model = JConvTDF(**TINY, norm=norm)
    tree = finit(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, 4), jnp.float32))
    return model, lively(tree, seed)["params"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _trace_order(norm_leaves):
    """The tiny net's parameters in forward order (2 scales, 1 block a
    scale), spelled out apart from either mapper's own order."""
    def dense(pre):
        yield (pre, "blocks_0_shortcut", "weight")
        for sub in ("tfc1_0", "tfc1_2", "tdf_0", "tdf_2", "tdf_3", "tdf_5", "tfc2_0", "tfc2_2"):
            if sub.endswith(("_0", "_3")):
                for leaf in norm_leaves:
                    yield (pre, f"blocks_0_{sub}", leaf)
            else:
                yield (pre, f"blocks_0_{sub}", "weight")

    yield ("first_conv", "weight")
    for i in range(2):
        yield from dense(f"ds_dense_{i}")
        yield (f"ds_{i}", "weight")
    yield from dense("mid_dense")
    for i in range(2):
        yield (f"us_{i}", "weight")
        yield from dense(f"us_dense_{i}")
    yield ("final_conv", "weight")


def _anonymous_onnx(leaves, norm: str) -> bytes:
    """Initializers named onnx::W_i, one node each in trace order: Conv,
    ConvTranspose, MatMul (weights stored (in, out)), and a norm as Mul and
    Add or as one BatchNormalization of four tensors."""
    inits, nodes, i = [], [], 0
    while i < len(leaves):
        p, a = leaves[i]
        if norm == "BatchNorm" and a.ndim == 1:
            names = [f"onnx::W_{i + j}" for j in range(4)]
            inits += [TENSOR(n, leaves[i + j][1]) for j, n in enumerate(names)]
            nodes.append(NODE("BatchNormalization", [f"x{i}", *names], [f"x{i + 4}"]))
            i += 4
            continue
        name = f"onnx::W_{i}"
        if a.ndim == 4:
            op = "ConvTranspose" if re.fullmatch(r"us_\d+", p[-2]) else "Conv"
            inits.append(TENSOR(name, a))
        elif a.ndim == 2:
            op = "MatMul"
            inits.append(TENSOR(name, a.T))
        else:
            op = "Mul" if p[-1] == "weight" else "Add"
            inits.append(TENSOR(name, a))
        nodes.append(NODE(op, [f"x{i}", name], [f"x{i + 1}"]))
        i += 1
    return FIELD(7, 2, b"".join(nodes + inits))


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_onnx_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrs = {f"w.{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate([(3,), (2, 5), (4, 1, 3, 3), (1,)])}
    graph = b"".join([NODE("Conv", ["x", "w.2"], ["y"]), NODE("Add", ["y", "w.0"], ["z"])]
                     + [TENSOR(k, a) for k, a in arrs.items()])
    path = tmp_path / "g.onnx"
    path.write_bytes(FIELD(7, 2, graph))
    ti, tn = tonnx.read_onnx_graph(str(path))
    ji, jn = jonnx.read_onnx_graph(str(path))
    assert tn == jn == [("Conv", ["x", "w.2"], ["y"]), ("Add", ["y", "w.0"], ["z"])]
    _assert_same(ti, ji)
    _assert_same(ti, arrs)


@pytest.mark.parametrize("norm", ["GroupNorm2", "BatchNorm"])
def test_name_route_matches_jax(tmp_path, norm):
    """torch-named initializers (the down/up convs also as a Sequential's
    ``ds.0.0.weight``): the port's route gives the JAX route's tree through
    the bridge, which is the written tree."""
    jmodel, params = _jax_params(norm, seed=1)

    def torch_name(path):
        name = ".".join(re.sub(r"(?<=\d)_", ".", re.sub(r"_(?=\d)", ".", p)) for p in path)
        return re.sub(r"^(ds|us)\.1\.", r"\1.1.0.", name)  # scale 1 as a Sequential

    leaves = list(_leaves(params))
    path = tmp_path / "named.onnx"
    path.write_bytes(FIELD(7, 2, b"".join(TENSOR(torch_name(p), a) for p, a in leaves)))
    got = tonnx.convtdf_state_from_onnx(str(path), ConvTDFNetTrim(**TINY, norm=norm))
    ref = convtdf_state_dict(jax.tree.map(np.asarray, jonnx.convtdf_params_from_onnx(str(path))))
    _assert_same(got, ref)
    _assert_same(got, convtdf_state_dict(params))


@pytest.mark.parametrize("norm", ["GroupNorm2", "BatchNorm"])
def test_structural_route_matches_jax(tmp_path, norm):
    """Anonymous initializers walked in trace order: the port's route gives
    the JAX route's tree through the bridge, which is the written tree; one
    conv's shape corrupted, both refuse the file."""
    jmodel, params = _jax_params(norm, seed=2)
    stats = ("running_mean", "running_var") if norm == "BatchNorm" else ()
    by_path = dict(_leaves(params))
    order = list(_trace_order(("weight", "bias", *stats)))
    assert sorted(order) == sorted(by_path)
    leaves = [(p, by_path[p]) for p in order]
    path = tmp_path / "anon.onnx"
    path.write_bytes(_anonymous_onnx(leaves, norm))
    port_model = ConvTDFNetTrim(**TINY, norm=norm)
    got = tonnx.convtdf_state_from_onnx(str(path), port_model)
    ref = convtdf_state_dict(jax.tree.map(np.asarray, jonnx.convtdf_params_from_onnx(
        str(path), model=jmodel)))
    _assert_same(got, ref)
    _assert_same(got, convtdf_state_dict(params))

    bad = tmp_path / "bad.onnx"
    bad.write_bytes(_anonymous_onnx([(p, a[:1] if a.ndim == 4 else a) for p, a in leaves], norm))
    with pytest.raises(ValueError, match="shape"):
        tonnx.convtdf_state_from_onnx(str(bad), port_model)
    with pytest.raises(ValueError, match="shape"):
        jonnx.convtdf_params_from_onnx(str(bad), model=jmodel)
