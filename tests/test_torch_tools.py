"""The profile tool's kernel categories, on the CPU.

`tools/profile_train.py` sums device time by category from the kernels'
demangled names; PERF.md's per-step table reads those sums. Each port
kernel's name, as the CUDA toolkit's cu++filt prints it, must land in its
source's forward or backward column, so that a redesigned kernel's time is
compared with its predecessor's; its per-kernel list keeps each kernel's
template arguments (which head dim ran). And the step A/B tool's legs,
which profile_train's `_clip_step` and `_gpt_step` take, and the backward
A/B tool's norm rows, which must cover every path's width.
"""
import pytest

from megatron_clip_tpu_torch.tools.ab_backward import NORM_ROWS
from megatron_clip_tpu_torch.tools.ab_step import LEGS, leg_args
from megatron_clip_tpu_torch.tools.profile_train import (_category,
                                                         _kernel_label)

_D = "mct::Dropout"
_FLASH_VIEW = "(anonymous namespace)::View<__nv_bfloat16 const>"
_SHORT = "mct::attn_short::Maps, mct::attn_short::Args"
_SHORT_BWD = "mct::attn_short_bwd::Maps, mct::attn_short_bwd::Args"
_LN = ("__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, "
       "long, int, float")
_LN_BWD = ("__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
           "const*, __nv_bfloat16*, float*, long, int, float")
_SPLIT = ("(anonymous namespace)::hop::SplitMaps, (anonymous namespace)::"
          "hop::SplitArgs")


@pytest.mark.parametrize("name,category", [
    # the wgmma forward: fwd<D, two-pass, dropout>
    (f"void mct::attn_fwd::fwd<64, true, false>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_fwd::fwd<128, true, true>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_fwd::fwd<64, false, false>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (flash_attention.cu)"),
    (f"void mct::attn_fwd::fwd<128, false, true>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (flash_attention.cu)"),
    # ViT-H/14's head of 80: the fused forward only
    (f"void mct::attn_fwd::fwd<80, true, false>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_fwd::fwd<80, true, true>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})", "attention fwd (fused_mha.cu)"),
    # the mma.sync and CUDA-core kernels they stand beside
    ("void (anonymous namespace)::tc::fwd<80, false>(__nv_bfloat16 const*, "
     "(anonymous namespace)::Pitch, __nv_bfloat16*, (anonymous "
     f"namespace)::Pitch, __nv_bfloat16*, float*, float*, int, int, int, "
     f"float, int, {_D})", "attention fwd (fused_mha.cu)"),
    (f"void (anonymous namespace)::tc::fwd<48, false>({_FLASH_VIEW}, "
     f"{_FLASH_VIEW}, {_FLASH_VIEW}, (anonymous namespace)::View<"
     f"__nv_bfloat16>, float*, int, int, int, int, float, int, {_D})",
     "attention fwd (flash_attention.cu)"),
    (f"void (anonymous namespace)::tc::bwd_kv<64, true, false>("
     f"{_FLASH_VIEW}, {_FLASH_VIEW})", "attention bwd (flash_attention.cu)"),
    (f"void (anonymous namespace)::hop::bwd_fused<128, true>((anonymous "
     f"namespace)::hop::Maps, (anonymous namespace)::hop::Args, {_D})",
     "attention bwd (flash_attention.cu)"),
    # the split flash backward on wgmma: bwd_dq / bwd_dkv<D, drop>
    (f"void (anonymous namespace)::hop::bwd_dq<64, false>({_SPLIT}, {_D})",
     "attention bwd (flash_attention.cu)"),
    (f"void (anonymous namespace)::hop::bwd_dq<128, true>({_SPLIT}, {_D})",
     "attention bwd (flash_attention.cu)"),
    (f"void (anonymous namespace)::hop::bwd_dkv<64, false>({_SPLIT}, {_D})",
     "attention bwd (flash_attention.cu)"),
    (f"void (anonymous namespace)::hop::bwd_dkv<128, true>({_SPLIT}, {_D})",
     "attention bwd (flash_attention.cu)"),
    ("void (anonymous namespace)::tc::bwd_dq_rc<64, true>(__nv_bfloat16 "
     "const*)", "attention bwd (fused_mha.cu)"),
    ("void (anonymous namespace)::tc::bwd_dkdv<64, true>(__nv_bfloat16 "
     "const*)", "attention bwd (fused_mha.cu)"),
    ("void (anonymous namespace)::hop::fused_ce_bwd_gemm<0>((anonymous "
     "namespace)::hop::GemmMaps)", "fused CE bwd (fused_ce.cu)"),
    # the wgmma recompute backward: bwd_dq / bwd_dkdv<D, drop>
    (f"void mct::attn_bwd::bwd_dq<128, true>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_bwd::bwd_dkdv<64, false>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_bwd::bwd_dq<80, false>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_bwd::bwd_dq<80, true>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_bwd::bwd_dkdv<80, false>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_bwd::bwd_dkdv<80, true>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})", "attention bwd (fused_mha.cu)"),
    # the fused CE forward on wgmma, its CUDA-core twin and the combine
    ("void (anonymous namespace)::hop::fused_ce_fwd_gemm((anonymous "
     "namespace)::hop::Maps, (anonymous namespace)::hop::Args)",
     "fused CE fwd (fused_ce.cu)"),
    ("void (anonymous namespace)::simt::fused_ce_fwd<float>(float const*)",
     "fused CE fwd (fused_ce.cu)"),
    ("(anonymous namespace)::fused_ce_combine(float const*, float const*, "
     "float const*, int, int, float*, float*)", "fused CE fwd (fused_ce.cu)"),
    # the one-pass forward at S <= 128: fwd<keys, mode>
    (f"void mct::attn_short::fwd<64, 0>({_SHORT})",
     "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_short::fwd<80, 1>({_SHORT})",
     "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_short::fwd<80, 2>({_SHORT})",
     "attention fwd (fused_mha.cu)"),
    (f"void mct::attn_short::fwd<128, 1>({_SHORT})",
     "attention fwd (fused_mha.cu)"),
    # the one-pass backward at S <= 128: bwd<keys, saved P>
    (f"void mct::attn_short_bwd::bwd<64, true>({_SHORT_BWD})",
     "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_short_bwd::bwd<80, true>({_SHORT_BWD})",
     "attention bwd (fused_mha.cu)"),
    (f"void mct::attn_short_bwd::bwd<80, false>({_SHORT_BWD})",
     "attention bwd (fused_mha.cu)"),
    # the persistent norm forward: ln_fwd<T, lanes, chunks, exact, RMS>, a
    # LayerNorm whose exact chunk count puts `true` before its last argument
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, 32, 3, true, "
     f"false>({_LN})", "layernorm fwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, 16, 4, true, "
     f"false>({_LN})", "layernorm fwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<float, 32, 8, false, false>("
     f"{_LN})", "layernorm fwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, 32, 4, true, "
     f"true>({_LN})", "rmsnorm fwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<float, 32, 2, false, true>("
     f"{_LN})", "rmsnorm fwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_fwd_any<__nv_bfloat16, false>("
     "float)", "layernorm fwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_fwd_any<float, true>(float)",
     "rmsnorm fwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_fwd<__nv_bfloat16, true>(float)",
     "rmsnorm fwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_bwd<__nv_bfloat16, false>(float)",
     "layernorm bwd (layernorm.cu)"),
    # the persistent norm backward: ln_bwd<T, P, lanes, chunks, exact, RMS>
    # and the sum over its blocks, ln_bwd_sum<P, RMS>; the forward with the
    # parameters' dtype P
    (f"void (anonymous namespace)::ln_bwd<__nv_bfloat16, __nv_bfloat16, "
     f"32, 3, true, false>({_LN_BWD})", "layernorm bwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_bwd<__nv_bfloat16, __nv_bfloat16, "
     f"16, 4, true, false>({_LN_BWD})", "layernorm bwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_bwd<__nv_bfloat16, float, 64, 4, "
     f"true, false>({_LN_BWD})", "layernorm bwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_bwd<__nv_bfloat16, float, 32, 4, "
     f"true, true>({_LN_BWD})", "rmsnorm bwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_bwd<float, float, 64, 4, false, "
     f"true>({_LN_BWD})", "rmsnorm bwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_bwd_sum<__nv_bfloat16, false>(float "
     "const*, int, int, __nv_bfloat16*)", "layernorm bwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_bwd_sum<float, true>(float const*, "
     "int, int, float*)", "rmsnorm bwd (layernorm.cu)"),
    ("void (anonymous namespace)::ln_bwd_any<float, __nv_bfloat16, true>("
     "float)", "rmsnorm bwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, __nv_bfloat16, 32, "
     f"3, true, false>({_LN})", "layernorm fwd (layernorm.cu)"),
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, float, 32, 4, "
     f"true, true>({_LN})", "rmsnorm fwd (layernorm.cu)"),
])
def test_every_port_kernel_lands_in_its_column(name, category):
    assert _category(name) == category


@pytest.mark.parametrize("name,label", [
    (f"void mct::attn_fwd::fwd<80, true, false>(mct::attn_fwd::Maps, "
     f"mct::attn_fwd::Args, {_D})",
     "void mct::attn_fwd::fwd<80, true, false>"),
    (f"void mct::attn_bwd::bwd_dkdv<80, false>(mct::attn_bwd::Maps, "
     f"mct::attn_bwd::Args, {_D})",
     "void mct::attn_bwd::bwd_dkdv<80, false>"),
    ("void (anonymous namespace)::tc::fwd<64, false>(__nv_bfloat16 const*, "
     "(anonymous namespace)::Pitch, float*, int)",
     "void (anonymous namespace)::tc::fwd<64, false>"),
    ("(anonymous namespace)::fused_ce_combine(float const*, int)",
     "(anonymous namespace)::fused_ce_combine"),
    (f"void (anonymous namespace)::hop::bwd_dq<64, false>({_SPLIT}, {_D})",
     "void (anonymous namespace)::hop::bwd_dq<64, false>"),
    (f"void (anonymous namespace)::hop::bwd_dkv<128, true>({_SPLIT}, {_D})",
     "void (anonymous namespace)::hop::bwd_dkv<128, true>"),
    (f"void mct::attn_short::fwd<80, 1>({_SHORT})",
     "void mct::attn_short::fwd<80, 1>"),
    (f"void (anonymous namespace)::ln_fwd<__nv_bfloat16, 16, 4, true, "
     f"false>({_LN})",
     "void (anonymous namespace)::ln_fwd<__nv_bfloat16, 16, 4, true, false>"),
])
def test_profile_labels_keep_the_template_arguments(name, label):
    assert _kernel_label(name) == label


@pytest.mark.parametrize("leg,want", [
    (LEGS[0], {"model": "gpt-pipeline", "seq": 512, "batch": None,
               "fused_ce": False, "recompute": False}),
    (LEGS[1], {"model": "ViT-L-14", "seq": 2048, "batch": 64,
               "fused_ce": False, "recompute": True}),
    (LEGS[2], {"model": "ViT-H-14", "seq": 2048, "batch": 24,
               "fused_ce": False, "recompute": True}),
    ("--model gpt-345m --seq 8192 --batch 1 --fused-ce",
     {"model": "gpt-345m", "seq": 8192, "batch": 1, "fused_ce": True,
      "recompute": False}),
])
def test_ab_step_legs_give_profile_train_options(leg, want):
    assert vars(leg_args(leg)) == want


def test_ab_backward_norm_rows_cover_every_path_width():
    """LayerNorm at each CLIP tower's and GPT's width (512 to 2048), the
    RMSNorm of the example GPT at 1024; scales in the path's dtype."""
    widths = {kind: {w for _, k, _, w, _ in NORM_ROWS if k == kind}
              for kind in ("layer_norm", "rms_norm")}
    assert widths == {"layer_norm": {512, 768, 1024, 1280, 2048},
                      "rms_norm": {1024}}
    assert {pdt for *_, pdt in NORM_ROWS} == {"bf16", "fp32"}
