"""Test and drive helpers of the port: :class:`StateHarness` builds valid
signed blocks against a live state."""

from .harness import StateHarness

__all__ = ["StateHarness"]
