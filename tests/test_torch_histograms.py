"""The two histograms of the paper's §V-B study on the port, on the CPU.

- `ir_histogram` (the ATen graph on meta tensors, the role of the
  reference's ``jaxpr_histogram``) totals `trace_cost(...).ops` exactly, for
  the loss of the reduced dense, MoE and SSM models.
- `kernel_name` normalises real H100 kernel names, as torch.profiler
  recorded them on the card (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128;
  ``chip_smoke.py``'s ``accuracy`` phase, and a profile of the port's
  kernels and a few ATen ops): cuBLAS / CUTLASS products, ATen elementwise
  and reduce kernels, copies, and the port's K1 / K2 / K3.
- `kernel_histogram` raises where no CUDA device runs the call, and
  `kernel_histogram_of` on a profile without device kernels, rather than
  return a histogram of the CPU; `cpu_op_histogram` is the CPU's, by name.
- On a profile shaped as `profile_call` records it on the card,
  `kernel_histogram_of` counts the call's device events only (not the
  lead-in fills, not the annotation spans), and raises where a launch,
  copy or fill of the call has no device event, as the card's profiles
  at times lose their first launch; `profile_call` takes such a profile
  again, up to `PROFILE_ATTEMPTS` times, and then raises.
"""
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import hlo_analysis as H
from repro_torch.core.unit_of_work import trace_cost
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model


def _meta_loss(arch):
    m = build_model(reduced(get_config(arch)), device="meta")
    params = L.map_specs(lambda s: torch.empty(
        L.stored_shape(s), dtype=L.spec_dtype(s) or torch.float32,
        device="meta"), m.specs())
    batch = m.input_specs(ShapeConfig("x", "train", 16, 2))
    return (lambda p, b: m.loss(p, b)[0]), params, batch


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "mamba2-780m"])
def test_ir_histogram_totals_the_unit_of_work(arch):
    fn, params, batch = _meta_loss(arch)
    hist = H.ir_histogram(fn, params, batch)
    assert sum(hist.values()) == trace_cost(fn, params, batch).ops > 0
    assert all(isinstance(v, int) and v > 0 for v in hist.values())
    assert "mm" in hist or "bmm" in hist


# (name as torch.profiler records it on the card, normalised name): copies
# and fills, cuBLAS's Hopper and sm80 products, a CUTLASS product and
# cuBLAS's split-K reduce, ATen's elementwise, reduce, softmax, sort,
# gather and cat kernels, and K1 / K2 / K3 (f32 and bf16)
H100_NAMES = [
    ('Memcpy DtoD (Device -> Device)',
     'Memcpy DtoD (Device -> Device)'),
    ('Memcpy HtoD (Pageable -> Device)',
     'Memcpy HtoD (Pageable -> Device)'),
    ('Memset (Device)',
     'Memset (Device)'),
    ('nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT',
     'nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT'),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_warpsiz'
     'e1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas',
     'sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_'
     'warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas'),
    ('void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>(cut'
     'lass_80_simt_sgemm_64x64_8x5_nn_align1::Params)',
     'Kernel2'),
    ('void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float,'
     ' float, false, float, float, float, true, false, false, '
     'false>(cublasLt::cublasSplitKParams<float>, float const*, float '
     'const*, float*, float*, float const*, float const*, float const*, '
     'float const*, float*, void*, long, float*, int*, float*, float*, '
     'float const*, float const*, float const*, float const*, float '
     'const*)',
     'splitKreduce_kernel'),
    ('void (anonymous namespace)::softmax_warp_forward<float, float, '
     'float, 9, false, false>(float*, float const*, int, int, int, bool '
     'const*, int, bool)',
     'softmax_warp_forward'),
    ('void at::native::radixSortKVInPlace<-2, -1, 32, 32, c10::BFloat16, '
     'long, unsigned int>(at::cuda::detail::TensorInfo<c10::BFloat16, '
     'unsigned int>, unsigned int, unsigned int, unsigned int, '
     'at::cuda::detail::TensorInfo<long, unsigned int>, unsigned int, '
     'bool)',
     'radixSortKVInPlace'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
     'at::native::MeanOps<float, float, float, float>, unsigned int, '
     'float, 4, 4> >(at::native::ReduceOp<float, '
     'at::native::MeanOps<float, float, float, float>, unsigned int, '
     'float, 4, 4>)',
     'reduce_kernel'),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::FillFunctor<int>, std::array<char*, 1ul> >(int, '
     'at::native::FillFunctor<int>, std::array<char*, 1ul>)',
     'vectorized_elementwise_kernel'),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::AbsFunctor<float>, std::array<char*, 2ul> >(int, '
     'at::native::AbsFunctor<float>, std::array<char*, 2ul>)',
     'vectorized_elementwise_kernel'),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy'
     '_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() '
     'const::{lambda()#7}::operator()() const::{lambda(float)#1}, '
     'std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned int>,'
     ' TrivialOffsetCalculator<1, unsigned int>, '
     'at::native::memory::LoadWithCast<1>, '
     'at::native::memory::StoreWithCast<1> >(int, '
     'at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambd'
     'a()#3}::operator()() const::{lambda()#7}::operator()() '
     'const::{lambda(float)#1}, std::array<char*, 2ul>, '
     'TrivialOffsetCalculator<1, unsigned int>, TrivialOffsetCalculator<1,'
     ' unsigned int>, at::native::memory::LoadWithCast<1>, '
     'at::native::memory::StoreWithCast<1>)',
     'unrolled_elementwise_kernel'),
    ('void at::native::vectorized_gather_kernel<16, long>(char*, char*, '
     'long*, int, long, long, long, long, bool)',
     'vectorized_gather_kernel'),
    ('void at::native::(anonymous '
     'namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous '
     'namespace)::OpaqueType<2u>, unsigned int, 2, 128, 1, 16, 8>(char*, '
     'at::native::(anonymous '
     'namespace)::CatArrInputTensorMetadata<at::native::(anonymous '
     'namespace)::OpaqueType<2u>, unsigned int, 128, 1>, '
     'at::native::(anonymous namespace)::TensorSizeStride<unsigned int, '
     '4u>, int, unsigned int)',
     'CatArrayBatchedCopy_vectorized'),
    ('void rt::flash_attention_kernel<float, 64, 64, 64>(float const*, '
     'float const*, float const*, float*, int, int, int, int, int, int, '
     'float, float)',
     'flash_attention_kernel'),
    ('void rt::tc::flash_attention_bf16_kernel<64, 2, 4, '
     '64>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 '
     'const*, __nv_bfloat16*, int, int, int, int, int, int, float, float)',
     'flash_attention_bf16_kernel'),
    ('void rt::flash_decode_kernel<float, 64, 1>(float const*, float '
     'const*, float const*, int const*, float*, float*, float*, float*, '
     'int*, int, int, int, int, int, int, int, int, float, float)',
     'flash_decode_kernel'),
    ('void rt::ssd_intra_kernel<float, 64>(float const*, float const*, '
     'float const*, float const*, float const*, float*, float*, float*, '
     'float*, int, int, int, int, int)',
     'ssd_intra_kernel'),
    ('void rt::ssdtc::ssd_tc_kernel<64, 1>(__nv_bfloat16 const*, float '
     'const*, float const*, __nv_bfloat16 const*, __nv_bfloat16 const*, '
     'float*, float*, float*, float*, int, int, int, int, int, int, int)',
     'ssd_tc_kernel'),
]


@pytest.mark.parametrize("raw,want", H100_NAMES)
def test_kernel_names_normalise(raw, want):
    assert H.kernel_name(raw) == want


def test_port_kernels_keep_their_names():
    for names in H.PORT_KERNEL_NAMES.values():
        for n in names:
            assert H.kernel_name(n) == n
            assert H.kernel_name(f"void {n}<2, 4, true>(float const*, int)") \
                == n


def test_kernel_histogram_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.ones(4)
    with pytest.raises(RuntimeError, match="CUDA device"):
        H.kernel_histogram(lambda: x * 2)


def test_a_cpu_profile_gives_no_kernel_histogram():
    x = torch.ones(8, 8)
    prof = H.profile_call(lambda: (x @ x).sum(), cuda=False)
    with pytest.raises(RuntimeError, match="no device kernel"):
        H.kernel_histogram_of(prof)
    ops = H.cpu_op_histogram(prof)
    assert ops == {"matmul": 1, "sum": 1}
    assert H.find_scope_labels(prof, "nugget_block_attn") == []


def test_histogram_delta_is_the_references():
    from repro.core.hlo_analysis import histogram_delta as ref
    a = {"mul": 5, "view": 3, "mm": 2}
    b = {"vectorized_elementwise_kernel": 4, "mm": 2, "mul": 1}
    assert H.histogram_delta(a, b) == ref(a, b)


def _event(name, id, start, end, device=False, annotation=False):
    from types import SimpleNamespace
    return SimpleNamespace(
        name=name, id=id, is_user_annotation=annotation, device_index=0,
        device_type=SimpleNamespace(name="CUDA" if device else "CPU"),
        time_range=SimpleNamespace(start=start, end=end))


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _lead_in_and_call(lose=()):
    """A profile as `profile_call` makes it on the card: two lead-in fills
    (the first lost, as the card lost it), then the call's range with an
    ATen op's kernel launch, a ``cuLaunchKernelEx`` product and a copy, each
    with its device event unless its id is in ``lose``."""
    cpu = [_event("cudaLaunchKernel", 1, 1, 2), _event("cudaLaunchKernel",
                                                        2, 3, 4),
           _event("cudaDeviceSynchronize", 3, 5, 6),
           _event(H.CALL_RANGE, 100, 10, 40),
           _event("aten::arange", 101, 11, 14),
           _event("cudaLaunchKernel", 4, 12, 13),
           _event("cuLaunchKernelEx", 5, 15, 16),
           _event("cudaMemcpyAsync", 6, 17, 18),
           _event("cudaDeviceSynchronize", 7, 41, 42)]
    dev = [_event("void at::native::vectorized_elementwise_kernel<4>(int)",
                  2, 5, 6, device=True),
           _event("void (anonymous namespace)::elementwise_kernel_with_"
                  "index<int>(int)", 4, 20, 21, device=True),
           _event("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", 5, 22, 30,
                  device=True),
           _event("Memcpy DtoD (Device -> Device)", 6, 31, 32, device=True),
           _event(H.CALL_RANGE, 100, 20, 32, device=True, annotation=True)]
    return _Profile(cpu + [e for e in dev if e.id not in lose])


def test_the_lead_in_and_annotation_spans_are_left_out():
    hist = H.kernel_histogram_of(_lead_in_and_call())
    assert hist == {"elementwise_kernel_with_index": 1,
                    "nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT": 1,
                    "Memcpy DtoD (Device -> Device)": 1}


@pytest.mark.parametrize("lost", [4, 5, 6])
def test_a_lost_launch_of_the_call_raises(lost):
    with pytest.raises(RuntimeError, match="lost the device events of 1 "):
        H.kernel_histogram_of(_lead_in_and_call(lose={lost}))


def test_without_a_call_range_every_launch_must_have_its_event():
    prof = _lead_in_and_call()
    whole = _Profile([e for e in prof.events() if e.name != H.CALL_RANGE])
    with pytest.raises(RuntimeError, match="lost the device events of 1 "):
        H.kernel_histogram_of(whole)
    kept = _Profile([e for e in whole.events() if e.id != 1])
    assert H.kernel_histogram_of(kept)["vectorized_elementwise_kernel"] == 1


@pytest.mark.parametrize("lossy", [0, 1, H.PROFILE_ATTEMPTS - 1])
def test_a_profile_that_lost_events_is_taken_again(monkeypatch, lossy):
    taken = []

    def once(fn, args, cuda):
        assert cuda
        fn(*args)
        taken.append(1)
        return _lead_in_and_call(lose={5} if len(taken) <= lossy else ())
    monkeypatch.setattr(H, "_profile_once", once)
    calls = []
    prof = H.profile_call(calls.append, "x")
    assert prof.attempts == lossy + 1 == len(taken) == len(calls)
    assert sum(H.kernel_histogram_of(prof).values()) == 3


def test_a_lossy_profile_keeps_its_kernels_and_names_its_lost_launches():
    """The error carries the call's kernels that kept their device events
    and, for each lost launch, the ATen op that made it (or the API call)."""
    prof = _lead_in_and_call(lose={4, 5})
    events = {e.id: e for e in prof.events() if e.device_type.name == "CPU"}
    events[4].cpu_parent = events[101]
    events[101].cpu_parent = events[100]
    with pytest.raises(H.LostDeviceEvents) as err:
        H.kernel_histogram_of(prof)
    assert [H.kernel_name(k.name) for k in err.value.kernels] == \
        ["Memcpy DtoD (Device -> Device)"]
    assert err.value.lost_ops == ["aten::arange", "cuLaunchKernelEx"]


def test_profiles_that_all_lost_events_raise(monkeypatch):
    monkeypatch.setattr(H, "_profile_once", lambda fn, args, cuda:
                        _lead_in_and_call(lose={4}))
    with pytest.raises(H.LostDeviceEvents):
        H.profile_call(lambda: None)
