from .pose_score import (POS_THRESH, ROT_THRESH_DEG, error_orientation, error_translation,
                         speed_score, speed_score_batched)

__all__ = ["POS_THRESH", "ROT_THRESH_DEG", "error_orientation", "error_translation",
           "speed_score", "speed_score_batched"]
