"""The port's reference-checkpoint converters against the JAX package's,
as ``test_torch_import_export.py`` holds them, for the SST family
(``EncoderSST``, ``DecoderSSTSkip`` and the convolutional integrator
``ConvResnet``, at 16x16 zones): the checks and their tolerances are
``test_torch_reference_standins``'s."""

import pytest

from test_torch_reference_standins import (
    check_export,
    check_forecast,
    check_import,
    family_dirs,  # noqa: F401 (a fixture)
)
from torch_threads import few_torch_threads  # noqa: F401

HERE = ["sst-convresnet"]


@pytest.mark.parametrize("family", HERE)
def test_import_matches_the_jax_importer_bitwise(family, family_dirs):
    check_import(family_dirs(family))


@pytest.mark.parametrize("family", HERE)
def test_imported_forecasts_agree_with_jax(family, family_dirs):
    check_forecast(family_dirs(family))


@pytest.mark.parametrize("family", HERE)
def test_export_matches_the_jax_exporter_and_round_trips(family, family_dirs, monkeypatch):
    check_export(family_dirs(family), monkeypatch)
