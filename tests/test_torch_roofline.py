"""The port's roofline accounting (`lav_tpu_torch/utils/roofline.py`) on
the CPU.

* `classify_op` puts every C entry of `utils/native.py::ENTRIES` and every
  `__global__` function of `csrc/` (as the profiler names it) in its
  source's class, and real library kernel names (cuDNN and CUTLASS
  convs, cuBLAS GEMMs, PyTorch's elementwise, reduction, sort, index,
  scatter and copy kernels) in theirs, none of which is the port's;
* `per_class_ms` equals lav_tpu's on the same {name: us} (lav_tpu's XLA op
  names), with its fusion kinds ignored;
* `roofline_summary` of a CPU conv and linear counts their analytic FLOPs;
* `parse_trace` reads a CPU profiler run (the profile and its Chrome
  trace), and a card's kernel events from a trace; a card's trace with
  CUDA activity but no kernel raises rather than giving host times, and
  `profile_device` takes such a run again, then raises;
  `parse_trace_by_stage` puts each kernel under the `agent/*` label
  around its launch;
* the peaks are the H100 SXM's, named for it.
"""

import json
import os
import re

import pytest
import torch

from lav_tpu.utils import roofline as J
from lav_tpu_torch.utils import native
from lav_tpu_torch.utils import roofline as R


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_every_source_has_a_class():
    assert set(R.HAND_CLASSES) == set(native.SOURCES)


@pytest.mark.parametrize("symbol", sorted(native.ENTRIES))
def test_classify_hand_entries(symbol):
    assert R.classify_op(symbol) == R.hand_class(symbol) == \
        R.HAND_CLASSES[native.ENTRIES[symbol].source]


@pytest.mark.parametrize("source", sorted(R.HAND_CLASSES))
def test_classify_hand_kernel_functions(source):
    with open(os.path.join(R.CSRC, f"{source}.cu")) as f:
        text = f.read()
    names = R._GLOBAL.findall(text)
    assert len(names) == text.count("__global__") > 0
    for name in names:
        for shown in (f"void (anonymous namespace)::{name}<float, 4>"
                      f"(float const*, int)",
                      f"(anonymous namespace)::{name}(int const*, int)"):
            assert R.classify_op(shown) == R.hand_class(shown) == \
                R.HAND_CLASSES[source], shown
        # the same name in another namespace is not the port's
        assert R.hand_class(f"void at::native::{name}<float>(int)") is None


LIBRARY = [
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nchw_"
     "tilesize128x128x32_warpgroupsize1x1x1_g1_execute_segment_k_off_"
     "kernel__5x_cudnn", "conv"),
    ("sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_"
     "nchw_tilesize64x32x64_stage5_warpsize2x2x1_g1_tensor16x8x8_kernel",
     "conv"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false>"
     "(cudnnTensorStruct, float const*)", "conv"),
    ("cutlass_80_tensorop_s1688fprop_optimized_tf32_64x64_16x10_nhwc_"
     "align4", "conv"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas",
     "matmul"),
    ("ampere_sgemm_128x64_nn", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
     "(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor> > >",
     "reduce"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<"
     "at_cuda_detail::cub::DeviceRadixSortPolicy<float, long, int> >",
     "sort"),
    ("void at::native::index_elementwise_kernel<128, 4, "
     "at::native::gpu_index_kernel<at::native::index_kernel_impl> >",
     "gather"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
     "at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 4>",
     "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::(anonymous namespace)::histogram_kernel<float>"
     "(float const*)", "other"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>",
     "other"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const&, "
     "c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::"
     "{lambda()#7}::operator()() const::{lambda(long)#1}>(int, "
     "at::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const&, "
     "c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::"
     "{lambda()#7}::operator()() const::{lambda(long)#1}, "
     "function_traits<at::native::arange_cuda_out(c10::Scalar const&)>)",
     "elementwise"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::linspace_cuda_out(c10::Scalar const&, c10::Scalar const&, "
     "long, at::Tensor&)::{lambda()#2}::operator()() const::{lambda()#2}::"
     "operator()() const::{lambda(long)#1}>(int)", "elementwise"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, "
     "at::native::_cuda_scatter_gather_internal_kernel<true, float>"
     "::operator()<at::native::ReduceMaximum>(at::TensorIterator&, long, "
     "long, long, at::native::ReduceMaximum const&)::{lambda(int)#1}>"
     "(int, {lambda(int)#1})", "scatter"),
]


@pytest.mark.parametrize("name,cls", LIBRARY)
def test_classify_library_kernels(name, cls):
    assert R.classify_op(name) == cls
    assert R.hand_class(name) is None


XLA_NAMES = {"convolution.3": 4000.0, "dot.1": 1500.0,
             "dot_general.2": 500.0, "copy.5": 800.0, "transpose.2": 200.0,
             "sort.1": 120.0, "gather.4": 60.0, "dynamic-slice.1": 40.0,
             "reduce.7": 30.0, "fusion.12": 900.0, "add.3": 10.0,
             "multiply.1": 5.0, "scatter.2": 700.0, "while.1": 3.0}


def test_per_class_ms_equals_lav_tpu():
    want = J.per_class_ms(XLA_NAMES, iters=4)
    got = R.per_class_ms(XLA_NAMES, iters=4)
    assert got == want
    assert list(got) == list(want)        # largest first
    assert R.per_class_ms(XLA_NAMES, 4, fusion_kinds={"fusion.12": "conv"}
                          ) == got


def test_roofline_summary_counts_analytic_flops():
    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    lin = torch.nn.Linear(8 * 12 * 12, 10)
    x = torch.rand((2, 3, 12, 12), generator=g)

    @torch.no_grad()
    def fn(x):
        return lin(conv(x).flatten(1))

    s = R.roofline_summary(fn, (x,), iters=2)
    want = 2 * 2 * 8 * 12 * 12 * 3 * 9 + 2 * 2 * (8 * 12 * 12) * 10
    assert s["flops"] == want
    assert s["gflops"] == round(want / 1e9, 3)
    assert s["gbytes"] is None and s["hbm_gbs"] is None
    assert s["hand_kernels"] == {} and s["device"] == "cpu"
    assert s["device_ms"] > 0 and s["classes_ms"]["conv"] > 0
    assert s["peak_card"] == "NVIDIA H100 SXM, 700 W"


def test_parse_trace_reads_a_cpu_run(tmp_path):
    conv = torch.nn.Conv2d(3, 4, 3)
    lin = torch.nn.Linear(16, 8)
    x = torch.rand(1, 3, 10, 10)
    profs = []
    for _ in range(2):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                lin(conv(x).reshape(-1, 16))
        profs.append(prof)
    path = str(tmp_path / "trace.json")
    profs[0].export_chrome_trace(path)
    from_file = R.parse_trace(path)
    from_prof = R.parse_trace(profs[1])
    assert set(from_file) == set(from_prof)
    assert R.parse_trace(profs[1]) == from_prof   # read twice
    assert all(v >= 0 for v in from_file.values())
    assert any("conv" in k for k in from_file)
    assert any(k in from_file for k in ("aten::addmm", "aten::mm"))
    # self times: nested operators are not counted twice
    with open(path) as f:
        ops = [e for e in json.load(f)["traceEvents"]
               if e.get("cat") == "cpu_op"]
    span = max(e["ts"] + e["dur"] for e in ops) - min(e["ts"] for e in ops)
    assert sum(from_file.values()) <= span + 1e-6


def _card_trace(tmp_path):
    """A card's trace as torch.profiler writes it: record_function labels
    and launches on the host thread, kernels on the device's stream."""
    host = dict(ph="X", pid=1, tid=7)
    dev = dict(ph="X", pid=0, tid=3)
    events = [
        dict(host, cat="user_annotation", name="agent/seg", ts=0, dur=100),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=10,
             dur=2, args=dict(correlation=1)),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=20,
             dur=2, args=dict(correlation=2)),
        dict(host, cat="user_annotation", name="agent/planner", ts=200,
             dur=100),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=210,
             dur=2, args=dict(correlation=3)),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=220,
             dur=2, args=dict(correlation=4)),
        dict(host, cat="cuda_runtime", name="cudaMemcpyAsync", ts=400,
             dur=2, args=dict(correlation=5)),
        dict(host, cat="cpu_op", name="aten::add", ts=9, dur=5),
        dict(dev, cat="kernel", name="ampere_sgemm_128x64_nn", ts=30,
             dur=40, args=dict(correlation=1)),
        dict(dev, cat="kernel", name="void (anonymous namespace)::"
             "crop_q8_tiled<__nv_bfloat16, true>(...)", ts=230, dur=25,
             args=dict(correlation=3)),
        dict(dev, cat="kernel", name="ampere_sgemm_128x64_nn", ts=260,
             dur=10, args=dict(correlation=4)),
        dict(dev, cat="kernel", name="void at::native::reduce_kernel<512>",
             ts=72, dur=6, args=dict(correlation=2)),
        dict(dev, cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pinned)",
             ts=410, dur=3, args=dict(correlation=5)),
        dict(dev, cat="gpu_user_annotation", name="agent/seg", ts=30,
             dur=50),
    ]
    path = tmp_path / "card.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_parse_trace_reads_a_card_run(tmp_path):
    path = _card_trace(tmp_path)
    durs = R.parse_trace(path)
    assert durs == {"ampere_sgemm_128x64_nn": 50.0,
                    "void (anonymous namespace)::crop_q8_tiled<__nv_bfloat16,"
                    " true>(...)": 25.0,
                    "void at::native::reduce_kernel<512>": 6.0,
                    "Memcpy DtoH (Device -> Pinned)": 3.0}
    assert R.per_class_ms(durs, iters=2) == {"matmul": 0.025,
                                             "hand_crop": 0.0125,
                                             "reduce": 0.003, "copy": 0.0015}
    staged = R.parse_trace_by_stage(path)
    assert staged == {
        ("ampere_sgemm_128x64_nn", "agent/seg"): 40.0,
        ("ampere_sgemm_128x64_nn", "agent/planner"): 10.0,
        ("void (anonymous namespace)::crop_q8_tiled<__nv_bfloat16, true>"
         "(...)", "agent/planner"): 25.0,
        ("void at::native::reduce_kernel<512>", "agent/seg"): 6.0,
        ("Memcpy DtoH (Device -> Pinned)", ""): 3.0}


def _no_kernel_trace(tmp_path, **extra):
    """A card run's trace in which the profiler recorded the launches but
    none of the device's activity."""
    host = dict(ph="X", pid=1, tid=7)
    events = [dict(host, cat="cpu_op", name="aten::conv2d", ts=0, dur=50),
              dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=10,
                   dur=2, args=dict(correlation=1))]
    path = tmp_path / "no_kernels.json"
    path.write_text(json.dumps({"traceEvents": events, **extra}))
    return str(path)


def test_parse_trace_refuses_a_card_run_without_kernels(tmp_path):
    path = _no_kernel_trace(tmp_path)
    assert R.profiled_a_card(path)
    with pytest.raises(R.NoDeviceEvents):
        R.parse_trace(path)
    # the card's properties alone say the card was profiled
    path = tmp_path / "props.json"
    path.write_text(json.dumps({
        "traceEvents": [dict(ph="X", pid=1, tid=7, cat="cpu_op",
                             name="aten::mm", ts=0, dur=5)],
        "deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}]}))
    with pytest.raises(R.NoDeviceEvents):
        R.parse_trace(str(path))


class _Prof:
    """A profile object as parse_trace reads it: what it asked to record
    and its trace."""

    def __init__(self, path, activities):
        self.activities = set(activities)
        with open(path) as f:
            self._lav_trace = json.load(f)


def test_a_profile_that_asked_for_the_card_is_a_card_run(tmp_path):
    cpu_only = tmp_path / "cpu.json"
    cpu_only.write_text(json.dumps({"traceEvents": [
        dict(ph="X", pid=1, tid=7, cat="cpu_op", name="aten::mm", ts=0,
             dur=5)]}))
    acts = torch.profiler.ProfilerActivity
    assert R.parse_trace(_Prof(cpu_only, [acts.CPU])) == {"aten::mm": 5}
    with pytest.raises(R.NoDeviceEvents):
        R.parse_trace(_Prof(cpu_only, [acts.CPU, acts.CUDA]))


@pytest.mark.parametrize("empty_runs,raises", [(0, False), (2, False),
                                               (3, True)])
def test_profile_device_takes_an_empty_card_run_again(monkeypatch,
                                                      empty_runs, raises):
    calls, parses = [], []

    def parse(prof):
        parses.append(prof)
        if len(parses) <= empty_runs:
            raise R.NoDeviceEvents("none")
        return {"k": 1.0}

    monkeypatch.setattr(R, "parse_trace", parse)
    if raises:
        with pytest.raises(R.NoDeviceEvents):
            R.profile_device(lambda: calls.append(1), 2, "cpu")
    else:
        prof, durs = R.profile_device(lambda: calls.append(1), 2, "cpu")
        assert durs == {"k": 1.0} and prof is parses[-1]
    assert len(parses) == min(empty_runs + 1, 3)
    assert len(calls) == 2 * len(parses)


def test_roofline_summary_lists_only_the_ports_kernels(monkeypatch):
    hand = ("void (anonymous namespace)::crop_tiled<__nv_bfloat16, 8>"
            "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, int)")
    durs = {hand: 2000.0, LIBRARY[-3][0]: 1000.0, LIBRARY[-1][0]: 500.0,
            "ampere_sgemm_128x64_nn": 4500.0}
    monkeypatch.setattr(R, "profile_device",
                        lambda fn, iters, device: (None, durs))
    lin = torch.nn.Linear(8, 4)
    x = torch.rand(3, 8)
    with torch.no_grad():
        s = R.roofline_summary(lin, (x,), iters=2, device="cpu")
    assert s["hand_kernels"] == {hand: {"ms": 1.0, "flops": None}}
    assert s["classes_ms"] == {"matmul": 2.25, "hand_crop": 1.0,
                               "elementwise": 0.5, "scatter": 0.25}
    assert s["device_ms"] == 4.0 and s["flops"] == 2 * 3 * 8 * 4
    # the FLOPs over the library's 3 ms, not over the port's kernel's too
    assert s["achieved_tflops"] == round(s["flops"] / 3e-3 / 1e12, 2)


def test_peaks_are_the_h100s():
    assert (R.H100_PEAK_BF16_FLOPS, R.H100_PEAK_INT8_OPS,
            R.H100_PEAK_F32_FLOPS, R.H100_PEAK_HBM_BYTES) == \
        (989e12, 1979e12, 67e12, 3.35e12)
    assert R.PEAK_CARD == "NVIDIA H100 SXM, 700 W"
    with open(R.__file__) as f:
        assert not re.search(r"v5e|V5E|197e12|819e9", f.read())
