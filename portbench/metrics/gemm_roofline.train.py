"""Percent: the least time of the traced steps' block linears (ViTPose's
qkv, proj, fc1 and fc2: every forward, and for the student the input's
and the weight's gradients, from ``roofline/vit.py``) over the time of
the cuBLAS GEMM kernels.

Kernels matched (cuBLAS on the H100, torch 2.11 with CUDA 12.8, names as
a traced run of ``vitpose_fpd_coco.train`` shows them): ``nvjet_tst_*``,
240 a step, which is every block linear's forward (96 teacher, 48
student), input gradient (48) and weight gradient (48): the forwards'
``nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT`` and
``nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN``, the input gradients'
``nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN``, and the weight gradients'
``nvjet_tst_{128x160,128x128,96x64}_*_NT[TN]``.  No convolution: cuDNN's
kernels for the patch embedding and the decoder (``implicit_convolve_
sgemm``, ``sm90_xmma_dgrad_implicit_gemm_*``) and the one
``cutlass_75_tensorop_bf16_s1688gemm`` call outside the blocks are left
out.
"""

from ._shares import roofline

GEMM_KERNELS = r"^nvjet_"


def read(r):
    return roofline(r, "gemm_bound_s", GEMM_KERNELS)
