"""Activation checkpointing (``checkpointing``): the port of
``deepspeed_tpu/runtime/activation_checkpointing/``."""
