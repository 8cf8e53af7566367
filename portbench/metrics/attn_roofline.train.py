"""Percent: the least time of the traced steps' attention calls (ViTPose:
the teacher's forward x 24, the student's forward and backward x 12, each
call's operations and bytes from ``roofline/vit.py``) over the time the
attention kernels took.

Kernels matched (the cuDNN attention that SDPA picks under bf16 autocast
on the H100, torch 2.11 with CUDA 12.8, names as a traced run of
``vitpose_fpd_coco.train`` shows them): the forward
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_*`` (36 a
step), the backward ``cudnn_generated_fort_native_sdpa_sm90_flash_bprop_
wgmma_f16_*`` with its ``cudnn::fusion::compute_dot_do_o_specialized``
and ``cudnn::fusion::convert_dq_to_16bits`` (12 a step each).
"""

from ._shares import roofline

ATTENTION_KERNELS = (r"^cudnn_generated_fort_native_sdpa_|"
                     r"^void cudnn::fusion::(compute_dot_do_o|convert_dq)")


def read(r):
    return roofline(r, "attn_bound_s", ATTENTION_KERNELS)
