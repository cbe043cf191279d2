"""The precision a configuration states decides its reference, its control
and its bytes: the tree's logits stored in `tree_dtype`, the control one
precision below `dtype`, and the logits' bytes in the roofline."""
import pytest
import torch

from benchmark import check, control, spec, trace, work
from benchmark.draws import KeyedDraws
from benchmark.reference import hex as ref_hex, learner, mcts, nets
from benchmark.reference.nets import fc
from benchmark.tests.conftest import tiny
from benchmark.weights import make

SEED = 4_000_000_017
BF16 = "hex9_512x4_bf16.selfplay"
PROXY_BF16 = -9984.0  # -1e4 rounded to bfloat16


def _worlds(B, S, plies, seed):
    """B boards of size S after `plies` random moves."""
    g = torch.Generator().manual_seed(seed)
    board = torch.full((B, S, S), ref_hex.EMPTY, dtype=torch.uint8)
    seats = torch.zeros(B, dtype=torch.int32)
    for _ in range(plies):
        valid = ref_hex.valid(board, seats)
        noise = torch.rand(valid.shape, generator=g)
        board, seats, _, _ = ref_hex.step(board, seats, torch.where(valid, noise, -1.0).argmax(-1))
    return board, seats


def _search(K, tree_dtype=None, prec="float32"):
    cfg = fc.tiny(dict(spec.cell("hex9_512x4.selfplay").config, boardsize=5))
    params = make(cfg, SEED, "cpu")
    board, seats = _worlds(16, 5, 6, 1)
    extra = () if tree_dtype is None else (tree_dtype,)
    return mcts.search(board, seats, learner.evaluator(params, cfg, prec),
                       KeyedDraws(SEED, "cpu"), 9, K, cfg["c_puct"], cfg["noise_eps"], *extra)


@pytest.mark.parametrize("K", [1, 4])
def test_a_float32_tree_is_the_search_without_a_tree_dtype(K):
    for a, b in zip(_search(K), _search(K, "float32")):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("K", [1, 4])
def test_a_bfloat16_tree_stores_rounded_logits_and_keeps_the_proxy(K, monkeypatch):
    read = []
    solve = mcts._solve

    def spy(logits, *args):
        read.append(logits)
        return solve(logits, *args)

    monkeypatch.setattr(mcts, "_solve", spy)
    logits, prior, _, _ = _search(K, "bfloat16", "bfloat16")
    assert read and all(x.dtype == torch.bfloat16 for x in read)
    assert prior.dtype == torch.float32
    invalid = ~ref_hex.valid(*_worlds(16, 5, 6, 1))
    assert invalid.any() and bool((prior[invalid] == PROXY_BF16).all())
    assert torch.equal(prior, prior.to(torch.bfloat16).float())
    assert bool((logits[invalid] == -torch.inf).all())
    # the same search on a float32 tree keeps -inf in the prior, and its
    # solved logits differ by the rounding
    f_logits, f_prior, _, _ = _search(K, "float32", "bfloat16")
    assert bool((f_prior[invalid] == -torch.inf).all())
    assert not torch.equal(f_logits, logits)


def test_search_bytes_count_the_trees_logits():
    B = 32768
    f32 = spec.cell("hex9_512x4.selfplay").config
    bf16 = spec.cell(BF16).config
    assert work.search_bytes(f32, B) == 8_866_234_432
    assert work.search_bytes(spec.cell("hex6_128x1.selfplay").config, B) == 24_648_745_464
    # the same search with 2-byte logits: rows of logit 2, count 2, value 4
    A, T = 81, work.tree_size(64, 8)
    rows = sum(R for R, _ in work.search_calls(bf16))
    assert work.search_bytes(bf16, B) == work.search_bytes(f32, B) - 2 * B * A * rows
    assert work.search_bytes(bf16, B) == sum(work.node_actions_bytes(B, R, A, K, T, logit_bytes=2)
                                             for R, K in work.search_calls(bf16))
    child, count = work.tree_types(T)
    assert 2 + count + 4 == 8 and child == 1


@pytest.mark.parametrize("dtype, device, want", [
    ("float32", "cpu", "bfloat16"), ("float32", "cuda", "tf32"),
    ("bfloat16", "cpu", "float8"), ("bfloat16", "cuda", "float8")])
def test_control_precision_is_the_next_below_the_configurations(dtype, device, want):
    assert control.control_precision(torch.device(device), {"dtype": dtype}) == want


def test_float8_rounds_every_matmul_input_and_passes_the_gradient():
    cfg = {"boardsize": 3, "width": 16, "depth": 2}
    params = {k: v.requires_grad_(True) for k, v in make(cfg, SEED, "cpu").items()}
    board, seats = _worlds(8, 3, 2, 2)
    args = (ref_hex.observe(board, seats), ref_hex.valid(board, seats), seats, cfg)
    l8, v8 = fc.forward(params, *args, prec="float8")
    l16, v16 = fc.forward(params, *args, prec="bfloat16")
    assert not torch.equal(l8, l16) and not torch.equal(v8, v16)
    # rounding a bf16 weight through float8 by hand gives the same forward
    rounded = {k: (v.detach().to(torch.bfloat16).to(torch.float8_e4m3fn).float()
                   if k.endswith("weight") else v.detach()) for k, v in params.items()}
    x = args[0].reshape(8, -1).to(torch.bfloat16).to(torch.float8_e4m3fn).to(torch.bfloat16)
    first = torch.nn.functional.linear(x, rounded["intake.dense.weight"].to(torch.bfloat16))
    x8 = nets.Float8.apply(args[0].reshape(8, -1).to(torch.bfloat16))
    assert torch.equal(x8, x)
    assert torch.equal(fc._dense(args[0].reshape(8, -1), params, "intake.dense", "float8"),
                       first + params["intake.dense.bias"].detach().to(torch.bfloat16))
    # the gradient goes through the rounding unchanged: every leaf's norm
    # within the forward's rounding of the bfloat16 gradient's
    norms = {}
    for prec, (logits, v) in (("float8", (l8, v8)), ("bfloat16", (l16, v16))):
        loss = logits.where(logits > -torch.inf, 0.0).sum() + v[:, 0].sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        norms[prec] = [float(torch.linalg.vector_norm(g)) for g in grads]
    assert all(n > 0 for n in norms["bfloat16"])
    assert all(abs(a - b) < 0.25 * b for a, b in zip(norms["float8"], norms["bfloat16"]))


def test_a_float32_tree_in_place_of_the_bf16_one_is_not_correct():
    """The bf16 network on a float32 tree, at a small size on the CPU,
    against the cell's reference and limits: the tree's rounding is part of
    what the cell checks. (The program passing and the float8 control
    failing are `test_bench_run`'s cases for every cell.)"""
    from benchmark.kinds import selfplay as sp

    cell = tiny(BF16)
    dev = torch.device("cpu")
    _, _, _, rec = sp.set_up(cell, SEED, dev)
    ref = sp.reference_outputs(cell, SEED, dev, rec, "bfloat16")
    cell.config = dict(cell.config, tree_dtype="float32")
    wrong = sp.compare(sp.reference_outputs(cell, SEED, dev, rec, "bfloat16"), ref)
    assert not check.judge(wrong, check.limits(BF16))[0], wrong


def test_gemm_ms_counts_every_cublas_kernel_of_the_bf16_step():
    """The cuBLAS and cuBLASLt kernels of a bf16 train step on the card, by
    their names in its trace, and two that are not cuBLAS's."""
    names = ["nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT",
             "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128_64x3_tn_align2>",
             "void gemmk1_kernel<int, float, 256, 5, false, false, false, false, "
             "cublasGemvTensorStridedBatched<__nv_bfloat16 const>>",
             "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float>",
             "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_w"]
    other = ["void (anonymous namespace)::node_actions_multi_kernel<16, true, __nv_bfloat16>",
             "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>"]
    events = [{"name": trace.WINDOW, "cat": "user_annotation", "ts": 0, "dur": 100, "tid": 1}]
    events += [{"name": n, "cat": "kernel", "ts": i, "dur": 1} for i, n in enumerate(names + other)]
    assert trace.Trace(events).kernel_s(trace.GEMM) == pytest.approx(len(names) * 1e-6)
