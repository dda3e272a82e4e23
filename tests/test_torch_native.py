"""The port's C++ wav loader (``waveglow_tpu_torch.native``) against scipy's
decode and the JAX package's loader, bit for bit: decode of PCM16, PCM32
and IEEE-float wavs, the batch's crops and zero padding, the header probe,
truncated and unsupported files, and the build (g++ at first use, named by
the source's hash, a failed build raising and leaving nothing behind)."""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from waveglow_tpu import native as jax_native
from waveglow_tpu_torch import native
from waveglow_tpu_torch.dsp.audio_io import wav_to_float32

ROOT = Path(__file__).resolve().parents[1]
SR = 22050


def write_wav(path, kind, n, seed):
  """A mono wav of ``n`` random samples: "pcm16", "pcm32" or "float32"."""
  rng = np.random.default_rng(seed)
  x = rng.uniform(-0.9, 0.9, n)
  if kind == "pcm16":
    data = (x * 32767).astype(np.int16)
  elif kind == "pcm32":
    data = (x * 2147483647).astype(np.int32)
  else:
    data = x.astype(np.float32)
  wavfile.write(str(path), SR, data)
  return path


def riff(*chunks):
  """A RIFF/WAVE file of the given (id, body, declared length) chunks."""
  body = b"WAVE"
  for cid, data, length in chunks:
    body += cid + struct.pack("<I", len(data) if length is None
                              else length) + data
  return b"RIFF" + struct.pack("<I", len(body)) + body


def fmt(bits=16, format_tag=1, channels=1):
  return struct.pack("<HHIIHH", format_tag, channels, SR,
                     SR * channels * bits // 8, channels * bits // 8, bits)


@pytest.mark.parametrize("kind", ["pcm16", "pcm32", "float32"])
def test_decode_matches_scipy(tmp_path, kind):
  path = write_wav(tmp_path / "a.wav", kind, 5000, seed=0)
  want, sr_want = wav_to_float32(path)
  got, sr = native.decode_wav(path)
  assert sr == sr_want == SR
  assert got.dtype == np.float32
  np.testing.assert_array_equal(got, want)
  assert native.wav_info(path) == (5000, SR)


@pytest.mark.parametrize("call", ["decode_wav", "wav_info", "batch"])
def test_missing_file_raises(tmp_path, call):
  missing = tmp_path / "nope.wav"
  with pytest.raises(ValueError, match="nope.wav"):
    if call == "batch":
      native.load_segments_batch([missing], [0], 16)
    else:
      getattr(native, call)(missing)


def test_batch_crops_and_pads(tmp_path):
  long_path = write_wav(tmp_path / "long.wav", "pcm16", 8000, seed=3)
  short_path = write_wav(tmp_path / "short.wav", "pcm16", 1000, seed=4)
  seg = 4096
  before = native.BATCHES
  batch = native.load_segments_batch(
      [long_path, short_path, long_path], [1234, -1, 7000], seg)
  assert native.BATCHES == before + 1
  assert batch.shape == (3, seg) and batch.dtype == np.float32
  long_wav, _ = wav_to_float32(long_path)
  short_wav, _ = wav_to_float32(short_path)
  np.testing.assert_array_equal(batch[0], long_wav[1234:1234 + seg])
  np.testing.assert_array_equal(batch[1][:1000], short_wav)
  assert not batch[1][1000:].any()
  # an offset near the end: the file's last 1000 samples, then zeros
  np.testing.assert_array_equal(batch[2][:1000], long_wav[7000:])
  assert not batch[2][1000:].any()


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_batch_equals_jax_loader(tmp_path, n_threads):
  """The same files and offsets through the JAX package's loader: the same
  bits, whatever the thread count."""
  paths = [write_wav(tmp_path / f"{i}.wav", kind, n, seed=i)
           for i, (kind, n) in enumerate([
               ("pcm16", 9000), ("pcm32", 7000), ("float32", 6000),
               ("pcm16", 1500), ("pcm16", 20000)])]
  offsets = [17, 2900, 0, -1, 15904]
  got = native.load_segments_batch(paths, offsets, 4096, n_threads=n_threads)
  want = jax_native.load_segments_batch(paths, offsets, 4096,
                                        n_threads=n_threads)
  assert got.tobytes() == want.tobytes()


def test_a_failing_file_is_named(tmp_path):
  good = write_wav(tmp_path / "good.wav", "pcm16", 3000, seed=0)
  bad = tmp_path / "bad.wav"
  bad.write_bytes(riff((b"fmt ", fmt(bits=24), None),
                       (b"data", bytes(300), None)))
  before = native.BATCHES
  with pytest.raises(ValueError, match="bad.wav"):
    native.load_segments_batch([good, bad, good], [0, 0, 0], 64)
  assert native.BATCHES == before  # no batch was decoded


@pytest.mark.parametrize("call", ["decode_wav", "wav_info", "batch"])
def test_truncated_fmt_chunk_is_refused(tmp_path, call):
  """A trailing ``fmt `` chunk that claims 16 bytes where fewer remain is
  not read past the end of the file: a ``ValueError``, not a crash."""
  path = tmp_path / "cut.wav"
  path.write_bytes(riff((b"data", bytes(40), None),
                        (b"fmt ", fmt()[:6], 16)))
  assert path.stat().st_size >= 44
  with pytest.raises(ValueError):
    if call == "batch":
      native.load_segments_batch([path], [0], 16)
    else:
      getattr(native, call)(path)


def test_data_chunk_is_clamped_to_the_file(tmp_path):
  """A data chunk that claims more bytes than the file holds is read up to
  the file's end, by the probe and by the decode alike."""
  samples = np.arange(-50, 50, dtype=np.int16)
  path = tmp_path / "short_data.wav"
  path.write_bytes(riff((b"fmt ", fmt(), None),
                        (b"data", samples.tobytes(), 10_000)))
  assert native.wav_info(path) == (100, SR)
  got, _ = native.decode_wav(path)
  np.testing.assert_array_equal(got, samples / np.float32(32768))
  batch = native.load_segments_batch([path], [40], 80)
  np.testing.assert_array_equal(batch[0][:60], samples[40:] / np.float32(32768))
  assert not batch[0][60:].any()


def test_header_probe_reads_64_kib(tmp_path):
  """The probe reads at most the first 64 KiB: past a 70 KB chunk of
  metadata it refuses, and the decode still counts the file in full."""
  samples = np.arange(300, dtype=np.int16)
  path = tmp_path / "meta.wav"
  path.write_bytes(riff((b"fmt ", fmt(), None), (b"LIST", bytes(70_000), None),
                        (b"data", samples.tobytes(), None)))
  with pytest.raises(ValueError):
    native.wav_info(path)
  got, sr = native.decode_wav(path)
  assert sr == SR
  np.testing.assert_array_equal(got, samples / np.float32(32768))
  # a long file: its count comes from the chunk, not from the bytes read
  long_path = write_wav(tmp_path / "long.wav", "pcm16", 100_000, seed=1)
  assert native.wav_info(long_path) == (100_000, SR)


@pytest.mark.parametrize("body", [
    fmt(bits=24), fmt(bits=8), fmt(channels=2), fmt(format_tag=3, bits=64)])
def test_unsupported_formats_are_refused(tmp_path, body):
  path = tmp_path / "odd.wav"
  path.write_bytes(riff((b"fmt ", body, None), (b"data", bytes(480), None)))
  for call in (native.decode_wav, native.wav_info):
    with pytest.raises(ValueError):
      call(path)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
  """An empty build directory and no library loaded yet."""
  build = tmp_path / "build"
  monkeypatch.setattr(native, "BUILD_DIR", build)
  monkeypatch.setattr(native, "_LIB", None)
  return build


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_leaves_nothing(tmp_path, monkeypatch,
                                                fresh_build, compiler):
  """A compiler that is not there, or one that fails: ``RuntimeError``
  (with the compiler's output), no file in the build directory, and no
  quiet fallback to Python."""
  if compiler == "missing":
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    match = "not found"
  else:
    script = tmp_path / "broken-g++"
    script.write_text("#!/bin/sh\necho 'error: no luck' >&2\nexit 1\n")
    script.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(script))
    match = "error: no luck"
  with pytest.raises(RuntimeError, match=match):
    native.get_lib()
  with pytest.raises(RuntimeError, match=match):
    native.load_segments_batch([tmp_path / "x.wav"], [0], 16)
  assert not fresh_build.exists() or not any(fresh_build.iterdir())


def test_build_is_named_by_the_source_hash(fresh_build):
  lib = native.build_library()
  assert lib.parent == fresh_build
  assert lib.name.startswith("wavloader_") and lib.suffix == ".so"
  assert [p.name for p in fresh_build.iterdir()] == [lib.name]
  assert native.build_library() == lib  # built once, then found
  assert native.get_lib()._name == str(lib)


def test_concurrent_first_builds_do_not_race(fresh_build):
  """Four processes that build into one empty directory at once all load a
  whole library, and one library is left, no temporary file."""
  code = ("import sys; from pathlib import Path; "
          "from waveglow_tpu_torch import native; "
          "native.BUILD_DIR = Path(sys.argv[1]); "
          "print(native.wav_info(sys.argv[2]))")
  wav = write_wav(fresh_build.parent / "a.wav", "pcm16", 500, seed=0)
  procs = [subprocess.Popen([sys.executable, "-c", code, str(fresh_build),
                             str(wav)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
           for _ in range(4)]
  outs = [proc.communicate(timeout=240) for proc in procs]
  for proc, (out, err) in zip(procs, outs):
    assert proc.returncode == 0, err
    assert out.strip() == f"(500, {SR})"
  assert len([p for p in fresh_build.iterdir()]) == 1
