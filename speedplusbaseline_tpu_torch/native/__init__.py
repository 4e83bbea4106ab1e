from .loader import decode_crop_resize, image_size, load, native_available

__all__ = ["decode_crop_resize", "image_size", "load", "native_available"]
