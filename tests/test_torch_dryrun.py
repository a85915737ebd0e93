"""The port's dry run (``repro_torch.launch.dryrun``) on fake ranks and
abstract tensors, held to the JAX package's.

* The recorder's FLOPs and collective bytes on a loop of known size
  (the counterpart of ``tests/test_dryrun.py::TestHloAnalysis``).
* Each kernel entry's abstract case records the FLOPs that
  ``FlopCounterMode`` counts over its plain version, forward and
  autograd, exactly.
* The stablelm smoke config's train, prefill and decode cells on a
  (2, 2) mesh: the port's argument bytes a device equal XLA's
  ``memory_analysis().argument_size_in_bytes`` for JAX's own steps under
  the same mesh, exactly, and the port's FLOPs are within 5% of
  ``hlo_analysis.analyze``'s (one JAX subprocess, 4 forced host devices).
* Production cells in-process: stablelm_3b ``train_4k`` on one pod;
  xlstm_125m ``train_4k`` on two pods (slow, as JAX's cell test is).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.registry import ShapeCell  # noqa: E402
from repro_torch.kernels import abstract, ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.graph_analysis import Recorder, analyze  # noqa: E402
from repro_torch.launch.mesh import make_fake_mesh  # noqa: E402
from repro_torch.parallel import collectives as coll  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_mesh():
    """Rank 0 of a fake 2-rank 'model' axis; the process group is
    destroyed afterwards."""
    mesh = make_fake_mesh((2,), ("model",), 0)
    yield mesh
    dist.destroy_process_group()


class TestGraphAnalysis:
    def test_loop_of_matmuls_and_all_reduces(self, fake_mesh):
        """12 steps of an (8,16) x (16,16) matmul and an all-reduce over a
        2-rank axis: 4096 x 12 FLOPs, 8 x 16 x 4 bytes x 2 (the ring) x
        12 all-reduced, 12 all-reduces."""
        rec = Recorder()
        with FakeTensorMode():
            x, w = torch.empty(8, 16), torch.empty(16, 16)
            with rec:
                for _ in range(12):
                    x = coll.all_reduce(x @ w, fake_mesh, "model")
        r = analyze(rec, fake_mesh)
        assert r["flops"] == 4096 * 12
        assert r["dot_bytes"] == (8 * 16 + 16 * 16 + 8 * 16) * 4 * 12
        assert r["collectives"]["per_kind"]["all-reduce"] == 8 * 16 * 4 * 2 * 12
        assert r["collectives"]["counts"]["all-reduce"] == 12
        assert r["collectives"]["per_kind"]["all-gather"] == 0

    def test_live_bytes_peak(self):
        """The peak of the storages created and held at once, in 512-byte
        blocks; views and writes into the arguments create nothing."""
        rec = Recorder()
        with FakeTensorMode():
            arg = torch.empty(1000)
            rec.known([arg])
            with rec:
                a = arg * 2                # 4000 bytes: 4096
                b = a[10:]                 # a view
                arg.add_(1)                # in place
                c = torch.empty(100)       # 400 bytes: 512
                del a, b, c
                d = torch.empty(10)        # 512, after the others are gone
        assert rec.peak_bytes == 4096 + 512
        assert rec.live_bytes == 512
        del d


def _abstract_flops(fn, inputs, grad: bool):
    """(forward records, backward records) of ``fn`` on abstract copies of
    ``inputs``, by kernel name."""
    fwd, bwd = Recorder(), Recorder()
    with FakeTensorMode():
        xs = [torch.empty(t.shape, dtype=t.dtype).requires_grad_(grad) for t in inputs]
        with abstract.recording(fwd):
            out = fn(*xs)
        if grad:
            with abstract.recording(bwd):
                torch.autograd.grad(out[0].sum(), xs)
    return fwd, bwd


def _plain_flops(fn, inputs, grad: bool):
    xs = [t.clone().requires_grad_(grad) for t in inputs]
    with FlopCounterMode(display=False) as f:
        out = fn(*xs)
    fwd = f.get_total_flops()
    if not grad:
        return fwd, 0
    with FlopCounterMode(display=False) as f:
        torch.autograd.grad(out[0].sum(), xs)
    return fwd, f.get_total_flops()


def _attn_inputs(B, H, KV, Sq, Sk, D):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, H, Sq, D, generator=g), torch.randn(B, KV, Sk, D, generator=g),
            torch.randn(B, KV, Sk, D, generator=g)]


def _ssd_inputs(B, S, H, P, N):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, S, H, P, generator=g), torch.rand(B, S, H, generator=g) + 0.1,
            -torch.rand(H, generator=g) - 0.1, torch.randn(B, S, N, generator=g),
            torch.randn(B, S, N, generator=g)]


def _mlstm_inputs(B, S, H, D):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(B, S, H, D, generator=g) for _ in range(3)] + [
        torch.randn(B, S, H, generator=g) for _ in range(2)]


KERNEL_CASES = {
    "attention_causal": ("flash_attention", lambda q, k, v: (ops.flash_attention(
        q, k, v, causal=True),), lambda q, k, v: (ref.attention_ref(q, k, v, causal=True),),
        _attn_inputs(2, 4, 2, 12, 12, 16), True),
    "attention_window_softcap": ("flash_attention", lambda q, k, v: (ops.flash_attention(
        q, k, v, causal=True, window=5, softcap=30.0),), lambda q, k, v: (ref.attention_ref(
            q, k, v, causal=True, window=5, softcap=30.0),), _attn_inputs(1, 4, 4, 9, 9, 16), True),
    "attention_decode": ("flash_attention", lambda q, k, v: (ops.flash_attention(
        q, k, v, causal=False),), lambda q, k, v: (ref.attention_ref(q, k, v, causal=False),),
        _attn_inputs(3, 8, 2, 1, 20, 16), True),
    "attention_lse": ("flash_attention_lse", lambda q, k, v: ops.flash_attention_lse(
        q, k, v, causal=False, softcap=50.0), lambda q, k, v: ref.attention_lse_ref(
            q, k, v, causal=False, softcap=50.0), _attn_inputs(2, 4, 2, 1, 11, 16), False),
    "ssd": ("ssd", lambda *a: ops.ssd_scan(*a, chunk=8), lambda *a: ref.ssd_chunked(*a, 8),
            _ssd_inputs(2, 16, 3, 4, 8), True),
    "ssd_padded": ("ssd", lambda *a: ops.ssd_scan(*a, chunk=8), lambda *a: ref.ssd_chunked(*a, 8),
                   _ssd_inputs(1, 13, 2, 8, 4), True),
    "mlstm": ("mlstm", lambda *a: ops.mlstm_scan(*a, chunk=8),
              lambda *a: ref.mlstm_chunked(*a, 8), _mlstm_inputs(2, 16, 3, 8), True),
    "mlstm_padded": ("mlstm", lambda *a: ops.mlstm_scan(*a, chunk=4),
                     lambda *a: ref.mlstm_chunked(*a, 4), _mlstm_inputs(1, 10, 2, 4), True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_abstract_kernel_flops_equal_the_plain_versions(case):
    """A kernel entry on abstract tensors records, forward and backward,
    exactly the FLOPs FlopCounterMode counts over its plain version and
    over that version's autograd; one launch of each direction."""
    name, entry, plain, inputs, grad = KERNEL_CASES[case]
    fwd, bwd = _abstract_flops(entry, inputs, grad)
    want_fwd, want_bwd = _plain_flops(plain, inputs, grad)
    assert fwd.kernel_launches == {name: 1}
    assert fwd.flops == want_fwd > 0
    if grad:
        assert bwd.kernel_launches == {f"{name}_bwd": 1}
        assert bwd.flops == want_bwd > 0


@pytest.mark.parametrize("B,Hl,dh", [(2, 4, 32), (4, 2, 64)])
def test_abstract_slstm_recurrence_is_the_loops(B, Hl, dh):
    """The sLSTM recurrence on abstract tensors (recorded whole, not run
    step by step) counts the loop's FLOPs exactly, forward and backward
    (FlopCounterMode's convention, on real tensors), holds for the
    backward the bytes the loop's autograd holds (within 1%), and peaks
    in the backward within 15% of the loop."""
    from repro_torch.models.xlstm import _slstm_scan

    S = 40

    def run(make):
        rec = Recorder()
        pre, R = make(B, S, 4, Hl, dh).requires_grad_(), make(4, Hl, dh, dh).requires_grad_()
        state = tuple(torch.zeros(B, Hl, dh) for _ in range(4))
        rec.known([pre, R, *state])
        with rec:
            hs, _ = _slstm_scan(pre, R, state)
            held, fwd = rec.live_bytes, rec.flops
            torch.autograd.grad(hs.sum(), [pre, R])
        return held, fwd, rec.flops - fwd, rec.peak_bytes

    loop = run(torch.randn)
    with FakeTensorMode():
        whole = run(lambda *shape: torch.empty(shape))
    assert whole[1:3] == loop[1:3]
    assert whole[0] == pytest.approx(loop[0], rel=0.01)
    assert whole[3] == pytest.approx(loop[3], rel=0.15)


def test_abstract_kernel_outputs_have_the_kernels_shapes():
    """The abstract case gives the plain version's output shapes and
    dtypes, and raises where the kernel would (a head dim it lacks)."""
    inputs = _attn_inputs(2, 4, 2, 1, 11, 16)
    want = ref.attention_lse_ref(*inputs, causal=False)
    with FakeTensorMode():
        got = ops.flash_attention_lse(*[torch.empty(t.shape) for t in inputs], causal=False)
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(torch.empty(1, 2, 4, 24), torch.empty(1, 2, 4, 24),
                                torch.empty(1, 2, 4, 24))


def test_attention_lse_ref_merges_over_key_splits():
    """The plain version's log-sum-exp merges partial outputs over any
    split of the keys into the whole attention, a part with no admitted
    key (lse -inf) included."""
    q, k, v = _attn_inputs(2, 4, 2, 1, 12, 16)
    want = ref.attention_ref(q, k, v, causal=False, softcap=20.0)
    parts = [ref.attention_lse_ref(q, k[:, :, s], v[:, :, s], causal=False, softcap=20.0)
             for s in (slice(0, 5), slice(5, 5), slice(5, 12))]
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - torch.logsumexp(lse, dim=0))
    got = sum(wi[..., None] * p[0] for wi, p in zip(w, parts))
    assert torch.isneginf(parts[1][1]).all() and not parts[1][0].any()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- against JAX's XLA --

SMOKE_CELLS = {"train": ShapeCell("train", 16, 4, "train"),
               "prefill": ShapeCell("prefill", 16, 4, "prefill"),
               "decode": ShapeCell("decode", 16, 4, "decode")}

JAX_CELLS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import smoke_config
    from repro.configs.registry import ShapeCell
    from repro.launch.hlo_analysis import analyze
    from repro.launch.specs import input_specs, sharding_mode
    from repro.models import Model
    from repro.parallel.sharding import (ShardingContext, param_sharding_abstract, resolve_spec,
                                         use_sharding)
    from repro.train.steps import (abstract_cache, batch_shardings, build_serve_step,
                                   build_train_step, cache_shardings, serving_param_shapes)

    cells = json.loads(sys.argv[1])
    cfg = smoke_config("stablelm_3b")
    model = Model(cfg)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for name, (seq, batch, kind) in cells.items():
        shape = ShapeCell(name, seq, batch, kind)
        ctx = ShardingContext(mesh=mesh, mode=sharding_mode(shape))
        specs = input_specs(cfg, shape)
        if kind == "train":
            step, state_sh, abstract_state = build_train_step(model, ctx)
            b_sh = batch_shardings(cfg, ctx, batch, seq)
            lowered = jax.jit(step, in_shardings=(state_sh, b_sh), out_shardings=(state_sh, None),
                              donate_argnums=(0,)).lower(abstract_state, specs)
        elif kind == "prefill":
            shapes, pspecs = serving_param_shapes(model)
            p_sh = param_sharding_abstract(shapes, pspecs, ctx)
            b_sh = batch_shardings(cfg, ctx, batch, seq)

            def prefill(params, b):
                with use_sharding(ctx):
                    logits, caches = model.forward(params, b, collect_kv=True)
                    return logits[:, -1:], caches

            lowered = jax.jit(prefill, in_shardings=(p_sh, b_sh)).lower(shapes, specs)
        else:
            shapes, pspecs = serving_param_shapes(model)
            p_sh = param_sharding_abstract(shapes, pspecs, ctx)
            cache = abstract_cache(model, batch, seq)
            c_sh = cache_shardings(model, ctx, batch, seq)
            tok_sh = {n: NamedSharding(mesh, P() if n == "cache_pos" else
                                       resolve_spec(("batch", "seq"), s.shape, ctx, "act"))
                      for n, s in specs.items()}
            lowered = jax.jit(build_serve_step(model, ctx), in_shardings=(p_sh, c_sh, tok_sh),
                              donate_argnums=(1,)).lower(shapes, cache, specs)
        compiled = lowered.compile()
        out[name] = {"argument_bytes": compiled.memory_analysis().argument_size_in_bytes,
                     "flops": analyze(compiled.as_text())["flops"]}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    cells = {n: [c.seq_len, c.global_batch, c.kind] for n, c in SMOKE_CELLS.items()}
    proc = subprocess.run([sys.executable, "-c", JAX_CELLS, json.dumps(cells)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SMOKE_CELLS))
def test_small_cells_match_jax(jax_cells, cell):
    """stablelm's smoke config on (2, 2), each cell's rank 0: argument
    bytes equal to XLA's exactly; FLOPs within 5% of the while-aware HLO
    count.  Causes of a gap in the FLOPs: XLA may fold a small matmul
    into elementwise code that ``analyze`` does not count, or pad a
    sharded dimension; the port counts what its rank dispatches (decode
    attends every query head over the rank's slice of the cache, the
    same products as JAX's heads over the whole cache) and a kernel's
    FLOPs by its JAX einsums."""
    rec = dryrun.run_config(smoke_config("stablelm_3b"), SMOKE_CELLS[cell], (2, 2),
                            ("data", "model"), rank=0)
    want = jax_cells[cell]
    assert rec["status"] == "ok"
    assert rec["per_device"]["argument_bytes"] == want["argument_bytes"], (rec, want)
    assert rec["per_device"]["flops"] == pytest.approx(want["flops"], rel=0.05), (rec, want)
    assert not dist.is_initialized()


def _check_production_record(rec, n_chips):
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == n_chips
    pd = rec["per_device"]
    assert pd["flops"] > 0 and pd["argument_bytes"] > 0 and pd["temp_bytes"] > 0
    assert pd["peak_hbm_est"] == (pd["argument_bytes"] + pd["output_bytes"] + pd["temp_bytes"]
                                  - pd["alias_bytes"])
    assert rec["collectives"]["total_bytes"] > 0


def test_production_cell_single_pod():
    """stablelm_3b train_4k on 256 fake ranks, in-process: a record with
    status ok, every layer's attention launched forward twice (remat) and
    backward once."""
    rec = dryrun.run_cell("stablelm_3b", "train_4k", "single")
    _check_production_record(rec, 256)
    assert rec["kernel_launches"] == {"flash_attention": 64, "flash_attention_bwd": 32}
    assert set(rec["per_device"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "alias_bytes", "peak_hbm_est", "flops", "flops_deep",
                                      "dot_bytes"}


@pytest.mark.slow
def test_production_cell_multi_pod():
    """xlstm_125m train_4k on the 2 x 16 x 16 fake mesh (its sLSTM runs a
    Python loop over the 4,096 positions), in-process."""
    rec = dryrun.run_cell("xlstm_125m", "train_4k", "multi")
    _check_production_record(rec, 512)
    assert set(rec["kernel_launches"]) == {"mlstm", "mlstm_bwd"}


def test_skipped_cell_carries_its_reason():
    rec = dryrun.run_cell("yi_34b", "long_500k", "single")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def test_cli_writes_a_record(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "gemma2_9b", "--shape", "long_500k", "--mesh", "multi", "--out",
                           str(out)], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    _check_production_record(rec, 512)
    assert rec["mode"] == "long" and "flash_attention_lse" in rec["kernel_launches"]
    assert np.isclose(rec["hw"]["peak_flops_bf16"], 989e12)
