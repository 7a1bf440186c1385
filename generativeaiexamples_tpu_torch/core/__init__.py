"""Shared pieces: configuration, logging, tracing and device resolution."""

from generativeaiexamples_tpu_torch.core.config import configclass, configfield
from generativeaiexamples_tpu_torch.core.configuration import AppConfig, get_config

__all__ = ["configclass", "configfield", "AppConfig", "get_config"]
