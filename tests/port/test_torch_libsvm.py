"""Port read_libsvm == the JAX package's, on files written to tmp_path:
1-based and 0-based indices, comment lines and trailing comments, ±1 labels
mapped to {0, 1} (other labels kept), num_features, no intercept, and the
same ValueError texts.  Exact equality: both parse the same text with
numpy."""
import numpy as np
import pytest

from photon_ml_tpu.data.libsvm import read_libsvm as jread
from photon_ml_tpu_torch.data.libsvm import read_libsvm as tread

FILES = {
    "one_based": "+1 1:0.5 3:2\n-1 2:1.5\n\n+1 3:-1 4:0.25\n",
    "zero_based": "1 0:0.5 2:2\n-1 1:1.5\n1 3:7\n",
    "comments": "# a header\n1 1:1 2:2 # trailing note 5:9\n-1 3:3\n  \n# end\n",
    "regression": "2.5 1:1\n-0.5 2:1\n1 1:3 2:4\n",
}
# (file, keyword arguments)
CASES = [("one_based", {}), ("one_based", {"num_features": 6}),
         ("one_based", {"add_intercept": False}), ("zero_based", {"zero_based": True}),
         ("comments", {}), ("regression", {}),
         ("one_based", {"binary_labels_to_01": False})]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in CASES])
def test_read_libsvm_matches_jax(tmp_path, name, kw):
    path = tmp_path / f"{name}.txt"
    path.write_text(FILES[name])
    xj, yj = jread(str(path), **kw)
    xt, yt = tread(str(path), **kw)
    assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    if kw.get("add_intercept", True):
        assert np.all(xt[:, -1] == 1.0)  # intercept last
    if name == "one_based" and "binary_labels_to_01" not in kw:
        assert set(yt) == {0.0, 1.0}


@pytest.mark.parametrize("text,kw", [
    ("1 0:1 2:3\n", {}),                          # 0 in a 1-based file
    ("1 1:1 9:3\n", {"num_features": 4}),         # past num_features
    ("1 -1:2\n", {"zero_based": True}),
], ids=["below_minimum", "out_of_range", "negative_zero_based"])
def test_errors_match_jax(tmp_path, text, kw):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as want:
        jread(str(path), **kw)
    with pytest.raises(ValueError) as got:
        tread(str(path), **kw)
    assert str(got.value) == str(want.value)
