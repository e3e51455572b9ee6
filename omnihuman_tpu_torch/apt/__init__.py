"""Seaweed-APT training (port of omnihuman_tpu/apt/): teacher data,
consistency distillation and the adversarial G / D steps."""
