"""The seeded subspace drawn on the card: the plain version of its kernels.

``ops/seeded_draw`` draws numpy's ``default_rng(key).standard_normal((N,
M0))`` on the card by a chunked parse of numpy's PCG64 stream (chunk maps
over entry offsets, a walk that composes them, fix-ups where a normal
overhangs a chunk past the maps, a last chunk that parses on) and
normalises in numpy's order. Here the plain version of those passes runs on
the host over numpy's own stream, at small chunks so that wedge and tail
draws straddle chunk ends, and is held bit for bit against numpy; the
committed ziggurat tables against numpy's draws and the installed numpy's
library; glibc's exp table against exact arithmetic and the host's libm;
the card's exp and log1p, as their plain versions compute them, against
the host's libm; the jump-ahead against ``PCG64.advance``; and the CPU
path of ``initial_subspace`` and of the sparse solve against what they
returned before (the host draw). The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.core import tools  # noqa: E402
from feastkit_tpu_torch.ops import cuda_build  # noqa: E402
from feastkit_tpu_torch.ops import seeded_draw as sd  # noqa: E402
from feastkit_tpu_torch.utils import trace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel workers on a few cores: keep torch's
    # and OpenBLAS's pools to one thread each
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _host_bits(N, M0):
    """What the precision ladder starts from on the host today."""
    q = tools.seeded_subspace(N, M0, np.float64)
    return q.astype(np.float32).astype(np.float64)


def _serial(N, M0, n):
    """numpy's stream parsed one normal after another: the values and each
    normal's (first, past-last) stream positions."""
    stream = sd._Stream(sd.stream_key(N, M0))
    vals, spans, p = [], [], 0
    for _ in range(n):
        v, q = sd.normal_plain(stream, p)
        vals.append(v)
        spans.append((p, q))
        p = q
    return np.array(vals), spans


@pytest.mark.parametrize("N,M0", [(1048576, 72), (65536, 72), (4096, 3)])
def test_tables_give_numpys_draws(N, M0):
    """The committed tables and tail constants, read by the plain version,
    give numpy's draws of the key, tails and wedge rejections among them."""
    n = 200_000
    vals, spans = _serial(N, M0, n)
    want = np.random.default_rng(sd.stream_key(N, M0)).standard_normal(n)
    assert np.array_equal(vals, want)
    ki, wi, fi, R, inv_R = sd.ziggurat()
    lengths = np.array([q - p for p, q in spans])
    assert (np.abs(vals) > R).sum() >= 10          # tail draws
    assert (lengths >= 3).sum() >= 100             # wedge rejections, tails


def test_header_is_the_installed_numpys():
    """The header holds what the script reads out of the installed numpy's
    libnpyrandom.a, and the script renders it unchanged."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import gen_ziggurat_tables as gen
    finally:
        sys.path.pop(0)
    archive = Path(np.__file__).parent / "random" / "lib" / "libnpyrandom.a"
    tables = gen.read_tables(archive)
    ki, wi, fi, R, inv_R = sd.ziggurat()
    assert list(np.frombuffer(tables["ki_double"], "<u8")) == ki
    assert list(np.frombuffer(tables["wi_double"], "<f8")) == wi
    assert list(np.frombuffer(tables["fi_double"], "<f8")) == fi
    text = (ROOT / "feastkit_tpu_torch" / "ops" / "csrc"
            / "npy_ziggurat.h").read_text()

    def body(header):               # less the line naming numpy's version
        return [line for line in header.splitlines()
                if "libnpyrandom.a by" not in line]
    assert body(text) == body(gen.render(tables))


@pytest.mark.parametrize("N,M0,chunk,entries,group", [
    (1000, 72, 7, 2, 5),
    (3001, 7, 16, 2, 4),
    (20000, 1, 7, 3, 8),
    (2048, 33, 11, 1, 3),
])
def test_chunked_parse_is_numpys(N, M0, chunk, entries, group):
    """The three passes at a small chunk (many chunks, wedge and tail draws
    straddling chunk ends, overhangs past the maps that the walk parses on
    the spot) give numpy's normals bit for bit."""
    n = N * M0
    got = sd.draw_plain(N, M0, chunk=chunk, entries=entries, group=group)
    want = np.random.default_rng(sd.stream_key(N, M0)).standard_normal(n)
    assert np.array_equal(got, want)
    # what the chunks cut: normals of several positions across a chunk end,
    # among them one that overhangs past the maps' entries
    _, spans = _serial(N, M0, n)
    cut = [(p, q) for p, q in spans if p // chunk != (q - 1) // chunk]
    assert any(q - p >= 2 for p, q in cut)
    assert any(q - (p // chunk + 1) * chunk >= entries for p, q in cut)


def test_a_short_stream_parses_on():
    """A stream provisioned too short: the last chunk parses on until every
    normal is written."""
    N, M0 = 700, 3
    got = sd.draw_plain(N, M0, chunk=64, chunks=5)
    want = np.random.default_rng(sd.stream_key(N, M0)).standard_normal(N * M0)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("N,M0", [(1, 5), (7, 1), (8193, 1), (20000, 1),
                                  (3001, 2), (999, 3), (4096, 72)])
def test_subspace_plain_is_the_host_draw(N, M0):
    """Draw, column norms in numpy's order (a chain a column; pairwise in
    blocks of numpy's buffer size where M0 = 1), division, float32
    rounding: the host's bits at odd shapes."""
    assert np.array_equal(sd.subspace_plain(N, M0), _host_bits(N, M0))


def test_pairwise_norm_follows_numpys_buffer_size():
    """M0 = 1 with numpy's buffer at another size: the plain norm reads it."""
    N = 5000
    w = np.random.default_rng(3).standard_normal((N, 1))
    old = np.getbufsize()
    try:
        np.setbufsize(1024)
        want = np.linalg.norm(w, axis=0)
        got = sd.norms_plain(w)
    finally:
        np.setbufsize(old)
    assert np.array_equal(got, want)
    assert np.array_equal(sd.norms_plain(w), np.linalg.norm(w, axis=0))


@pytest.mark.parametrize("delta", [0, 1, 2, 1023, 1 << 20, 77_529_088,
                                   (1 << 40) + 12345])
def test_jump_ahead_is_pcg64s(delta):
    """The kernels' jump-ahead, from the state numpy keys the draw with."""
    N, M0 = 1048576, 72
    state, inc = sd.stream_start(N, M0)
    rng = np.random.default_rng(sd.stream_key(N, M0))
    assert rng.bit_generator.state["state"] == {"state": state, "inc": inc}
    bits = np.random.PCG64(sd.stream_key(N, M0))
    bits.advance(delta)
    assert sd.advance(state, inc, delta) == bits.state["state"]["state"]


def test_exp_header_is_glibcs():
    """The committed exp table is the script's exact arithmetic and, where
    the host's libm is glibc's, that libm's ``__exp_data``; the plain
    version reads the header's constants."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import gen_glibc_exp_table as gen
    finally:
        sys.path.pop(0)
    words = gen.table()
    text = (ROOT / "feastkit_tpu_torch" / "ops" / "csrc"
            / "glibc_exp.h").read_text()
    assert text == gen.render(words)
    consts, tab = sd.exp_constants()
    assert consts == gen.CONSTANTS and tab == words
    libm = gen.host_libm()
    assert libm is not None
    assert gen.read_libm(libm) == dict(gen.CONSTANTS, table=words)


_EXP_EDGES = [-0.0, 0.0, -2.0 ** -60, -2.0 ** -55, -2.0 ** -54, -2.0 ** -53,
              -1e-300, -2.0 ** -9, -0.00270760617, -0.00270760618, -0.5,
              -1.0, -0.6931471805599453, -3.0, -6.676414, -6.7, 0.5, 1.0,
              20.0, -20.0, -511.0]
_LOG1P_EDGES = [-0.0, 0.0, -2.0 ** -60, -2.0 ** -54, -2.0 ** -53,
                -2.0 ** -30, -2.0 ** -29, -2.0 ** -20, -0.29289, -0.2929,
                -0.5, -0.5 + 2.0 ** -40, -0.75, -(1.0 - 2.0 ** -53),
                2.0 ** -40, 0.41421, 0.41422, 0.5, 1.0, 3.0, 1e300]


def _same(a: float, b: float) -> bool:
    return np.float64(a).view(np.uint64) == np.float64(b).view(np.uint64)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_exp_plain_is_the_hosts(seed):
    """The card's exp, operation for operation on the host, gives the host
    libm's bits on the wedge test's arguments (-x^2 / 2 for x < R) and on
    its branches' edges: glibc's x86-64 FMA build. The same operations
    without the fused multiply-adds differ on some of them."""
    R = sd.ziggurat()[3]
    x = R * np.random.default_rng(seed).random(6000)
    args = ((-0.5 * x) * x).tolist() + _EXP_EDGES
    bad = [a for a in args if not _same(sd.exp_plain(a), math.exp(a))]
    assert not bad, bad[:5]
    unfused = sd._fma
    try:
        sd._fma = lambda a, b, c: a * b + c
        assert any(not _same(sd.exp_plain(a), math.exp(a)) for a in args)
    finally:
        sd._fma = unfused
    with pytest.raises(ValueError):
        sd.exp_plain(-512.0)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_log1p_plain_is_the_hosts(seed):
    """The card's log1p, operation for operation on the host, gives the host
    libm's bits on the tail's arguments (-U) and on its branches' edges."""
    args = (-np.random.default_rng(seed).random(6000)).tolist() + _LOG1P_EDGES
    bad = [a for a in args if not _same(sd.log1p_plain(a), math.log1p(a))]
    assert not bad, bad[:5]
    assert math.isnan(sd.log1p_plain(-2.0))
    assert sd.log1p_plain(-1.0) == -math.inf


def test_initial_subspace_on_the_cpu_is_unchanged():
    """Without ``f32_bits_on`` the host draw as before; ``f32_bits_on``
    refuses a CPU device and what the card does not draw."""
    fpm = ft.feastinit()
    N, M0 = 3001, 17
    q = tools.initial_subspace(fpm, None, N, M0, np.float64)
    assert isinstance(q, np.ndarray)
    assert np.array_equal(q, tools.seeded_subspace(N, M0, np.float64))
    with pytest.raises(ValueError, match="CUDA device"):
        tools.initial_subspace(fpm, None, N, M0, np.float64,
                               f32_bits_on=torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA device"):
        sd.seeded_subspace_f32_bits(N, M0, "cpu")
    with pytest.raises(ValueError):
        tools.initial_subspace(fpm, None, N, M0, np.float32, f32_bits_on="cpu")
    with pytest.raises(ValueError):
        tools.initial_subspace(fpm, None, N, M0, np.complex128,
                               general=True, f32_bits_on="cpu")
    fpm[5] = 1
    with pytest.raises(ValueError):
        tools.initial_subspace(fpm, np.ones((N, M0)), N, M0, np.float64,
                               f32_bits_on="cpu")


def test_cpu_solve_keeps_the_host_draw():
    """A sparse polynomial solve on the CPU (mixed precision forced, the
    ladder's f32 start) draws on the host: its q0 span says so and holds
    the upload."""
    nx = 24
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()
    fpm = ft.feastinit()
    fpm[42] = 2
    before = sd.launch_counts()
    trace.clear()
    trace.enable()
    try:
        r = ft.feast(A, None, (0.0, 0.3), 16, fpm, solver="cheb",
                     device="cpu")
    finally:
        trace.disable()
    spans = trace.spans()
    trace.clear()
    assert r.info == 0
    q0 = [s for s in spans if s.name == "q0"]
    assert [s.attrs["draw"] for s in q0] == ["host"]
    assert [s.name for s in spans if s.parent == q0[0].index] == ["q0.upload"]
    assert sd.launch_counts() == before


def test_draw_launches_enter_the_launches_counter():
    base = trace.counters()["launches"]
    sd.seeded_draw_f64.launches += 5
    try:
        assert trace.counters()["launches"] == base + 5
    finally:
        sd.seeded_draw_f64.launches -= 5


def test_a_header_change_rebuilds(tmp_path, monkeypatch):
    """A library's name hashes the headers beside the sources."""
    (tmp_path / "k.cu").write_text('#include "t.h"\n')
    (tmp_path / "t.h").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    first = cuda_build.library_path("k")
    (tmp_path / "t.h").write_text("// two\n")
    assert cuda_build.library_path("k") != first
