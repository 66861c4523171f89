"""Duplex planning and dual-path MoE execution (port of ``repro.core``)."""
