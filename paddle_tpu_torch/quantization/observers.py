"""quantization.observers: the calibration observers."""
from . import AbsmaxObserver, BaseObserver

AbsMaxObserver = AbsmaxObserver  # the reference's capitalization

__all__ = ["AbsmaxObserver", "AbsMaxObserver", "BaseObserver"]
