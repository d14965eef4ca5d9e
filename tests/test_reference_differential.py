"""Three-leg differential tests against the compiled REFERENCE binary.

Mirrors the reference's own test strategy (SURVEY.md §4: cross-validation
round trips vs libdeflate, test/libdeflate.cpp:100-173) with the reference
itself as the second oracle:

  leg A: reference-compress (level 3, its only correct level) -> our inflate
  leg B: our compress -> reference-inflate
  leg C: sizes — ours must not exceed the reference's level-3 output

The reference headers are compiled once per module into a tiny CLI; the
tests skip when no reference checkout is available.
"""
import os
import subprocess
import zlib

import numpy as np
import pytest

import deflate_jax

# The reference's C++ headers and its image corpus, when a checkout of the
# reference is available: DEFLATE_REFERENCE_DIR=<dir> (with include/ and
# tiny.bmp / test.bmp).
REF = os.environ.get("DEFLATE_REFERENCE_DIR", "")

CLI_SRC = r"""
// Thin CLI over the reference headers (deflate.hpp:798, inflate.hpp:376):
// argv[1] = deflate|inflate, argv[2] = level (deflate only); stdin->stdout.
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include "deflate.hpp"
#include "inflate.hpp"
int main(int argc, char** argv) {
    (void)argc;
    std::vector<uint8_t> in;
    {
        uint8_t buf[65536];
        size_t n;
        while ((n = fread(buf, 1, sizeof buf, stdin)) > 0)
            in.insert(in.end(), buf, buf + n);
    }
    std::vector<uint8_t> out;
    if (!strcmp(argv[1], "deflate")) {
        out = deflate::compress(in, atoi(argv[2]));
    } else {
        out = inflate::decompress(in);
    }
    fwrite(out.data(), 1, out.size(), stdout);
    return 0;
}
"""


@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    """The reference CLI, built once per module; skips when the
    reference's headers are not available."""
    if not REF or not os.path.isdir(os.path.join(REF, "include")):
        pytest.skip("reference headers not available "
                    "(set DEFLATE_REFERENCE_DIR)")
    d = tmp_path_factory.mktemp("refcli")
    (d / "cli.cpp").write_text(CLI_SRC)
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", f"-I{REF}/include",
         str(d / "cli.cpp"), "-o", str(d / "cli")],
        capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"reference CLI failed to build: {r.stderr[-500:]}")
    return str(d / "cli")


def ref_deflate(cli, data: bytes, level: int = 3) -> bytes:
    return subprocess.run([cli, "deflate", str(level)], input=data,
                          capture_output=True, check=True).stdout


def ref_inflate(cli, data: bytes) -> bytes:
    return subprocess.run([cli, "inflate"], input=data,
                          capture_output=True, check=True).stdout


def _corpus(name):
    if name in ("tiny.bmp", "test.bmp"):
        with open(os.path.join(REF, name), "rb") as f:
            return f.read()
    return bytes(np.random.default_rng(0).integers(97, 120, 40000,
                                                   dtype=np.uint8))


NAMES = ["tiny.bmp", "test.bmp", "text"]


@pytest.mark.parametrize(
    "name", ["tiny.bmp", "test.bmp",
             pytest.param("text", marks=pytest.mark.slow)])
def test_leg_a_reference_stream_our_inflate(ref_cli, name):
    data = _corpus(name)
    stream = ref_deflate(ref_cli, data, 3)
    assert zlib.decompress(stream, -15) == data     # sanity: it's valid
    assert deflate_jax.decompress(stream) == data
    assert deflate_jax.decompress(stream, device=True,
                                  force_device=True) == data


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("level", [0, 2, 3])
def test_leg_b_our_stream_reference_inflate(ref_cli, name, level):
    data = _corpus(name)
    stream = deflate_jax.compress(data, level)
    assert ref_inflate(ref_cli, stream) == data


@pytest.mark.parametrize("name,bar", [("tiny.bmp", 67), ("test.bmp", 3124)])
def test_leg_c_size_at_or_below_reference_level3(ref_cli, name, bar):
    """The reference's level 3 is its only correct compressor; its sizes
    are the bar (SURVEY.md §6).  Both backends must beat it outright."""
    data = _corpus(name)
    native = deflate_jax.compress(data, 3, backend="native")
    assert len(native) <= bar
    device = deflate_jax.compress(data, 3)
    assert len(device) <= bar
