"""Wrappers the benchmark puts around the program's functions, at the
attribute through which the caller looks each one up (a module global):
`torch.profiler.record_function` spans for the traced run, and the capture
of what the timed path's sampler drew. Nothing is put inside the program."""

from __future__ import annotations

import contextlib
import functools
import importlib

import torch


def resolve(path: str):
    """(module, attribute) of a dotted path 'package.module.attribute'."""
    module, attr = path.rsplit(".", 1)
    return importlib.import_module(module), attr


def span(label: str):
    """fn -> fn inside a profiler span named `label`."""

    def wrap(fn):
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return spanned

    return wrap


@contextlib.contextmanager
def wrapped(factories: dict, paths: dict):
    """Replace the attribute at paths[name] by factories[name](original) for
    every name, and put the originals back on exit. A wrapper carries the
    original's attributes (such as a launch counter) and hands them back."""
    installed = []
    try:
        for name, factory in factories.items():
            module, attr = resolve(paths[name])
            original = getattr(module, attr)
            wrapper = functools.wraps(original)(factory(original))
            setattr(module, attr, wrapper)
            installed.append((module, attr, original, wrapper))
        yield
    finally:
        for module, attr, original, wrapper in reversed(installed):
            setattr(module, attr, original)
            for key, value in vars(wrapper).items():
                if key != "__wrapped__" and key in vars(original):
                    setattr(original, key, value)
