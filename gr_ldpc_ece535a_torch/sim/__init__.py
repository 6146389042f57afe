"""Monte-Carlo BER/FER waterfall experiments."""

from .waterfall import (DEFAULT_METHODS, WaterfallResult, band_check,
                        run_waterfall)

__all__ = ["WaterfallResult", "run_waterfall", "band_check", "DEFAULT_METHODS"]
