"""Batch: a closed loop of back-to-back ``Engine.step(steps_per_call)``
calls, one caller waiting on each, no render. Each call does
``steps_per_call`` steps of every alive body (and, under ``kdk_reuse``,
one more force pass, its seed)."""

from __future__ import annotations


def steps(traffic: dict) -> int:
    return int(traffic["steps_per_call"])


def call(eng, traffic: dict, probe):
    eng.step(steps(traffic))
    return None
