"""Shared integer helpers for tiled ops."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)
