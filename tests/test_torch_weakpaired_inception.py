"""The weak-paired trainer with the Inception-v3 trunk (``--cnn_arch
inception``, crop 75) against the JAX package's, on the CPU: one train step
per (variant, finetune phase), the validation NLL, and the CLI end to end.
The helpers, data and tolerances are ``test_torch_weakpaired.py``'s; the
cases sit in a file of their own because each JAX step compiles Inception's
forward and backward."""

import pytest

from test_torch_weakpaired import (  # noqa: F401  (corpora is a fixture)
    STEP_CASES,
    check_cli_resumes,
    check_train_step,
    check_val_step,
    corpora,
)


@pytest.mark.parametrize("variant,finetune", STEP_CASES)
def test_train_step_matches_jax(variant, finetune, monkeypatch):
    check_train_step("inception", variant, finetune, monkeypatch)


@pytest.mark.parametrize("variant", ["vqa_arch", "null"])
def test_val_step_matches_jax(variant, monkeypatch):
    check_val_step("inception", variant, monkeypatch)


@pytest.mark.parametrize("variant", ["vqa_arch", "null"])
def test_cli_writes_checkpoints_and_resumes(corpora, variant, tmp_path):  # noqa: F811
    check_cli_resumes(corpora, "inception", variant, tmp_path)
