"""Unique name generator (reference: python/paddle/fluid/unique_name.py
behaviour: per-key counters, ``guard`` to swap generators, ``switch``)."""
from __future__ import annotations

import contextlib
from collections import defaultdict

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.ids = defaultdict(int)
        self.prefix = prefix

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


# dygraph parameter names must stay unique across programs; the reference
# keeps a separate generator for that (unique_name.py generate_with_ignorable_key)
dygraph_parameter_name_generator = UniqueNameGenerator()


def generate_with_ignorable_key(key: str) -> str:
    return dygraph_parameter_name_generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
