"""Dataset evaluators (host numpy): COCO keypoint AP."""
