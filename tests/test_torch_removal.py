"""The removal builds' switches (`repro_torch.kernels.removal`): each one
that the script compiles with names a part that its kernel's source really
compiles out, so a renamed or dropped switch cannot leave a removal build
that silently times the full kernel. The builds themselves need ``nvcc`` and
a card."""
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.removal import SHAPES, SWITCHES

CASES = [(name, d) for name, switches in SWITCHES.items() for d in switches]


@pytest.mark.parametrize("name,define", CASES,
                         ids=[d for _, d in CASES])
def test_switch_guards_code_in_its_source(name, define):
    src = build.source_path(name).read_text()
    guards = re.findall(rf"^#if(?:n)?def {define}$", src, flags=re.M)
    assert guards, f"{define} guards nothing in {build.SOURCES[name]}"


def test_every_library_with_switches_is_timed():
    assert {name for name, _, _ in SHAPES} == set(SWITCHES)
