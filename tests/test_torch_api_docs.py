"""The port's API reference, ``docs/api_torch.md``.

``gr_ldpc_ece535a_torch/tools/gen_api_docs.py`` (the counterpart of
``tools/gen_api_docs.py``) writes every ``__all__`` name of its modules
with its signature and docstring. Every such name must appear in what it
renders, the committed file must be what it renders today, and it names
no path outside the checkout.
"""

import importlib
import inspect
from pathlib import Path

import pytest

from gr_ldpc_ece535a_torch.tools import gen_api_docs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def text():
    return gen_api_docs.render()


@pytest.mark.parametrize("modname", gen_api_docs.MODULES)
def test_every_public_name_is_documented(text, modname):
    mod = importlib.import_module(modname)
    assert f"## `{modname}`" in text
    names = mod.__all__
    assert names, modname
    for name in names:
        if not inspect.ismodule(getattr(mod, name)):
            assert (f"### `{name}" in text or f"### class `{name}" in text), \
                f"{modname}.{name}"


def test_committed_reference_is_current(text):
    assert (ROOT / "docs" / "api_torch.md").read_text() == text
    assert str(ROOT) not in text


def test_main_writes_out(tmp_path, monkeypatch, capsys):
    out = tmp_path / "api.md"
    monkeypatch.setattr(gen_api_docs, "OUT", out)
    gen_api_docs.main()
    assert out.read_text() == gen_api_docs.render()
    assert "symbols" in capsys.readouterr().out
