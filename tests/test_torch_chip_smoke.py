"""The structure of ``chip_smoke.py``, the port's card-side check, on the CPU.

Its phases run only on the card; here the phase list, the label selection,
the products the phases share and the count of checks are held without
calling ``main`` or any phase.
"""

import re

import pytest
import torch

import chip_smoke


def test_the_labels_are_unique_and_in_the_docstrings_order():
    labels = [label for label, _ in chip_smoke.PHASES]
    assert len(labels) == len(set(labels))
    listed = re.findall(r"^(\d+)\. ", chip_smoke.__doc__, re.MULTILINE)
    covered = [n for label in labels for n in label.split("-")]
    assert covered == [str(n) for n in range(int(covered[0]), int(covered[-1]) + 1)]
    assert covered == listed


@pytest.mark.parametrize("args", [["99"], ["9", "12"], ["9", "--all"]])
def test_an_unknown_label_is_refused(args):
    with pytest.raises(SystemExit) as refused:
        chip_smoke.main(args)
    message = str(refused.value.code)
    assert message.startswith("chip_smoke: unknown phase")
    assert " ".join(label for label, _ in chip_smoke.PHASES) in message


def test_no_label_selects_every_phase_and_labels_select_only_themselves():
    assert chip_smoke.selected_phases([]) == [label for label, _ in chip_smoke.PHASES]
    assert chip_smoke.selected_phases(["19", "9"]) == ["19", "9"]


@pytest.fixture
def context(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    return chip_smoke.Context(torch.device("cpu"), str(tmp_path))


@pytest.mark.parametrize("product", sorted(chip_smoke.PRODUCTS))
def test_a_product_two_phases_read_is_built_once(product, context, monkeypatch):
    built = []

    def builder(ctx):
        built.append(ctx)
        return object()

    monkeypatch.setitem(chip_smoke.PRODUCTS, product, builder)
    monkeypatch.setattr(chip_smoke, "PHASES", [
        ("a", lambda ctx: getattr(ctx, product)), ("b", lambda ctx: getattr(ctx, product))])
    results, seconds = chip_smoke.run_phases(["b", "a"], context)
    assert built == [context]
    assert list(results) == list(seconds) == ["a", "b"]
    assert results["a"] is results["b"]


def test_a_context_has_no_other_products(context):
    with pytest.raises(AttributeError):
        context.no_such_product


def test_the_selected_phases_run_in_the_order_of_the_list(context, monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke, "PHASES", [
        (label, lambda ctx, label=label: ran.append(label)) for label in ("1", "2", "3")])
    chip_smoke.run_phases(["3", "1"], context)
    assert ran == ["1", "3"]


def test_check_counts_the_checks_that_pass(monkeypatch):
    monkeypatch.setattr(chip_smoke, "checks_passed", 0)
    chip_smoke.check(True, "holds")
    chip_smoke.check(1 == 1, "holds again")
    with pytest.raises(SystemExit, match="chip_smoke FAILED: does not hold"):
        chip_smoke.check(False, "does not hold")
    assert chip_smoke.checks_passed == 2
