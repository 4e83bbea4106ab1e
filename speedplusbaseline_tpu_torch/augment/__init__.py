from .photometric import apply_augment, draw_augment
from .styleaug import StyleAugmentor, load_style_stats

__all__ = ["apply_augment", "draw_augment", "StyleAugmentor", "load_style_stats"]
