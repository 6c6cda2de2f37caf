"""Config dataclasses with a CLI bridge (copy of ``novel_vqa_tpu.core.config``).

Each tool declares one dataclass; ``add_dataclass_args`` exposes every field
as ``--name``, so the port's CLIs take the same flags as the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Type, TypeVar

T = TypeVar("T")


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type[T]) -> None:
    for field in dataclasses.fields(cls):
        if not field.init:
            continue
        default = (
            field.default
            if field.default is not dataclasses.MISSING
            else (
                field.default_factory()  # type: ignore[misc]
                if field.default_factory is not dataclasses.MISSING
                else None
            )
        )
        kwargs: dict[str, Any] = {"default": default, "help": f"(default: {default})"}
        if field.type in (bool, "bool") or isinstance(default, bool):
            kwargs["type"] = lambda s: s.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            kwargs["type"] = int
        elif isinstance(default, float):
            kwargs["type"] = float
        else:
            kwargs["type"] = str
        parser.add_argument(f"--{field.name}", **kwargs)


def dataclass_from_args(cls: Type[T], args: argparse.Namespace) -> T:
    names = {f.name for f in dataclasses.fields(cls) if f.init}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def parse_config(cls: Type[T], argv=None, description: str = "") -> T:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, cls)
    return dataclass_from_args(cls, parser.parse_args(argv))
