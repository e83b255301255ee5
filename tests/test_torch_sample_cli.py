"""gqe-torch-sample (graphqembed_tpu_torch.cli.sample) against the JAX
package's gqe-sample: on a scale-0.3 synthetic graph with 50 train, 20 val
and 20 test queries per structure, with and without --native, the two write
the same files, byte for byte. An npz archive stamps each member with the
time it was written, so npz files are compared member by member: the same
names and the same .npy bytes."""

import io
import zipfile
from pathlib import Path

import pytest

from graphqembed_tpu.cli import sample as jax_cli
from graphqembed_tpu_torch.cli import sample as cli
from jax_native_build import load_jax_native


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's sampler library, built under a lock before any test
    here calls it (see jax_native_build.py)."""
    return load_jax_native()


def _content(p: Path):
    if p.suffix != ".npz":
        return p.read_bytes()
    with zipfile.ZipFile(io.BytesIO(p.read_bytes())) as z:
        return [(i.filename, z.read(i)) for i in z.infolist()]


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): _content(p)
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("extra", [[], ["--native"]], ids=["python", "native"])
def test_sample_cli_writes_the_files_gqe_sample_writes(tmp_path, extra):
    argv = ["--synthetic_scale", "0.3", "--dataset", "bio-latent",
            "--n_train", "50", "--n_val", "20", "--n_test", "20",
            "--max_negs", "30", "--n_workers", "2", "--seed", "3", *extra]
    assert cli.main(argv + ["--out_dir", str(tmp_path / "port")]) == 0
    assert jax_cli.main(argv + ["--out_dir", str(tmp_path / "jax")]) == 0
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert {"graph_data.pkl", "train_queries", "val_queries", "test_queries"} <= {
        name.split("/")[0] for name in port}
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
