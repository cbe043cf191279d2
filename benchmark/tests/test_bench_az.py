"""The two metrics of AlphaGo Zero's tower cell read the kernels they name:
`conv_roofline`'s pattern every convolution kernel cuDNN launched in a card
trace of `hex9_az20x256_bf16.selfplay` (NVIDIA H100 80GB HBM3, PyTorch
2.11.0+cu128; forward, data and weight gradient), and no cuBLAS GEMM or
batch-norm kernel; `bn_ms.train`'s every batch-norm kernel of that trace,
eval and train mode, forward and backward, and no convolution, GEMM, ReLU
or residual add. The names are that trace's, cut at 200 characters. The
readers, on a hand-built trace, give the formulas their docstrings state."""
import importlib.util

import pytest

from benchmark import spec, trace, work
from benchmark.reference.nets import az

CONV = [
    "_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolutionINS1_11threadblock22ImplicitGemmMultistageINS_4gemm9GemmShapeILi128ELi64ELi32EEENS4_52Conv2dWgradOutputGradientTileAccessIteratorO",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x256x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128x64_warpgroupsize2x1x1_g1_execute_segment_k_on_kernel__5x_cudnn",
    "void cask_plugin__5x_cudnn::xmma__5x_cudnn::init_device_workspace_kernel<xmma__5x_cudnn::implicit_gemm::wgrad_indexed::Warp_specialized_params<xmma__5x_cudnn::Grid_constant_params> >(xmma__5x_cudnn::i",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8::Params)",
    "void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataType_t)0>(int, int, int, int, int, int, int, int, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, float, ",
]
BN = [
    "void at::native::(anonymous namespace)::unrolled_elementwise_kernel_for_multi_outputs<3, at::native::(anonymous namespace)::batch_norm_update_stats_and_invert(at::Tensor const&, at::Tensor const&, at:",
    "void at::native::batch_norm_backward_elemt_channels_last_kernel<4, c10::BFloat16, float, float>(c10::BFloat16 const*, c10::BFloat16 const*, float const*, float const*, float const*, float const*, floa",
    "void at::native::batch_norm_backward_reduce_channels_last_kernel<4, c10::BFloat16, float, float>(c10::BFloat16 const*, c10::BFloat16 const*, float const*, float const*, float*, float*, float*, float*,",
    "void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, c10::BFloat16, float, 4>(c10::BFloat16 const*, float*, float*, float volatile*, int*, int, int, float)",
    "void at::native::batch_norm_transform_input_channels_last_kernel<c10::BFloat16, float, float, 4>(c10::BFloat16 const*, c10::BFloat16 const*, float const*, float const*, float const*, float const*, c10",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::(anonymous namespace)::batch_norm_elementwise_backward_train(at::Tensor const&, at::Tensor const&, at::Tensor",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::batch_norm_calc_invstd(at::Tensor const&, at::Tensor const&, double)::{lambda()#1}::operator()() const::{lambda()#2",
]
# cuBLAS's and cuBLASLt's kernels of the heads' dense layers
GEMM = [
    "nvjet_tst_128x8_64x12_2x1_v_bz_TNT",
    "nvjet_tst_192x8_64x8_2x1_v_ssched_bz_TNT",
    "nvjet_tst_512x8_64x3_2x1_v_ssched_bz_TNT",
    "nvjet_tst_64x8_64x16_4x1_v_bz_NNT",
    "nvjet_tst_64x8_64x16_4x1_v_bz_TNT",
    "nvjet_tst_64x8_64x16_4x1_v_bz_splitK_NNT",
    "void cublasLt::splitKreduce_kernel<32, 16, int, __nv_bfloat16, __nv_bfloat16, float, __nv_bfloat16, false, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true, false, false, false>(cublasLt::cublasSplit",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, __nv_bfloat16, false, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, true, false, false, false>(cublasLt::cublasSplitKParams<",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, __nv_bfloat16, false, float, __nv_bfloat16, __nv_bfloat16, true, false, false, false>(cublasLt::cublasSplitKParams<float>, ",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_tn_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_tn_align1::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nn_align1::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nt_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_nt_align1::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tn_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tn_align1::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_64x64_nn_align1>(cutlass_75_tensorop_s1688gemm_bf16_64x64_nn_align1::Params)",
    "void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_64x64_nt_align1>(cutlass_75_tensorop_s1688gemm_bf16_64x64_nt_align1::Params)",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_64x256_32x4_tn_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_64x256_32x4_tn_align2::Params)",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_32x10_nt_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_64x64_32x10_nt_align2::Params)",
]
# the tower's ReLU and residual add, and the ReLU's backward
ELEMENTWISE = [
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<c10::BFloat16> const&):",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{lambda()#",
    "void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{lambda()#",
    "void at::native::vectorized_elementwise_kernel<8, at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::BFloat16, at::native::(anonymous namespace)::threshold_kernel_impl<c10::BFloat16>(at::Ten",
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul>)",
]
CELL = "hex9_az20x256_bf16.selfplay"


def _module(metric):
    path = spec.HERE / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(f"bench_az_{metric}", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def _matches(pattern, name):
    return any(m in name.lower() for m in pattern)


@pytest.mark.parametrize("metric, mine", [("conv_roofline", CONV), ("bn_ms.train", BN)])
def test_each_pattern_matches_its_kernels_alone(metric, mine):
    mod = _module(metric)
    pattern = mod.CONV if metric == "conv_roofline" else mod.BN
    assert all(_matches(pattern, n) for n in mine)
    others = [n for n in CONV + BN + GEMM + ELEMENTWISE if n not in mine]
    assert not [n for n in others if _matches(pattern, n)]


def _trace(kernels):
    """A window of 1 s holding the kernels (name, microseconds), back to back."""
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
               "dur": 1e6, "tid": 1, "pid": 1}]
    ts = 0.0
    for name, dur in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                       "tid": 7, "pid": 0})
        ts += dur
    return trace.Trace(events)


def test_the_readers_give_their_formulas():
    cfg = spec.cell(CELL).config
    tr = _trace([(CONV[0], 300e3), (CONV[-1], 100e3), (BN[0], 50e3), (BN[-1], 10e3),
                 (GEMM[0], 20e3), (ELEMENTWISE[0], 40e3)])
    ctx = {"cell": spec.cell(CELL), "trace": tr, "profiled": 2, "n_envs": cfg["n_envs"],
           "precision": "bfloat16"}
    flops = az.conv_macs(cfg) * cfg["n_envs"] * (2 * work.evaluations(cfg) + 6) * 2
    assert _module("conv_roofline").read(ctx) == pytest.approx(100 * flops / 0.4 / 989e12)
    assert _module("bn_ms.train").read(ctx) == pytest.approx(30.0)
    assert az.conv_macs(cfg) == 1_815_913_728 and az.macs(cfg) == 1_815_948_180
    # no convolution kernel, or a network without convolutions: nothing to read
    assert _module("conv_roofline").read(dict(ctx, trace=_trace([(GEMM[0], 1e3)]))) is None
    fc = spec.cell("hex9_512x4_bf16.selfplay")
    assert _module("conv_roofline").read(dict(ctx, cell=fc)) is None
