from .affine import affine_transform, get_affine_transform, transform_preds
from .flip import flip_back_torch, flip_pair_permutation

__all__ = ["affine_transform", "get_affine_transform", "transform_preds",
           "flip_back_torch", "flip_pair_permutation"]
