"""Pods bound in the measured window (every bind, rebinds of preempted
jobs included) over the window's wall seconds."""


def read(m):
    return m["pods"] / m["window_s"]
