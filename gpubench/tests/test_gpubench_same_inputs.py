"""The Dense U-Net family makes, for a seed, bit for bit what the harness
made before model families: the weights at the tests' cut and at
DenseNet-121's full widths, the frames, the requests and the sample, and
the operation counts. The digests are sha256 of the values as the harness
before families made them on the CPU."""

from __future__ import annotations

import hashlib
import json

import pytest

from _bench import configs, family, tiny_config
from gpubench import inputs

D121 = configs()["densenet121-mid2"]
UNET = family(D121)

BEFORE = {
    1: dict(
        tiny="fdc19d7c066f74e35300e3664058ba6683f9c8c10f36019b3dd70e8a9f1c8e57",
        full="d06e75ba3fc170349718abae818632779161073423d8d6dd84a696e6928d5584",
        frames="eb6006d633e8cbf754017237887c69793a8609e12d297676fe5ccf3bb1fd017a",
        requests="5175a4db1d3bfe8e91e611b98503daea15e3bcf7d8857a2312c9196982e2c860"),
    2**31 + 11: dict(
        tiny="d79f24a5b54358cf500802e2bb41ba2e62216a57ffada71869c669a2b62c12c4",
        full="3d79a78e13eb4b086dc30c1b13211db8307ed8711f1e290b572b6f0f2c1d1076",
        frames="af6163521a8113efccd0a00030415ad81a9e8ee28def859e835ac2a78c419c28",
        requests="c5e180d82b3d740f87de59756fc69f3de071f65027a50f86a43ba2ed8f5fa8cd"),
    2**33 + 7: dict(
        tiny="af00bad963dd5ab752915be14629cda56d9e6d6ad20043391ea59fa4c8bf4c4f",
        full="6f5d333bdff46e781ffa8999009ed2bb441805c6a47afeff491a9275c9e68079",
        frames="fd47a7864ff8928ef42a02134b5e020e96ae1589f91d3820d368cf15b4324aa6",
        requests="5781e28ae6716bb07ddf88a0bfdb666a04229d5012a955d787020e3cc6987f2e"),
}


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(BEFORE))
def test_weights_frames_and_requests_are_the_same_as_before(seed):
    before = BEFORE[seed]
    tiny = tiny_config(D121)["model"]
    assert digest(UNET.make_state_dict(tiny, seed, "cpu")) == before["tiny"]
    assert digest(UNET.make_state_dict(D121["model"], seed, "cpu")) == before["full"]
    rgb, lidar = inputs.make_frames(seed, 4, 128, 192, "cpu")
    assert digest({"rgb": rgb, "lidar": lidar}) == before["frames"]
    r = inputs.Requests(seed, [1, 4, 8], 32, 5)
    draws = [r.next() for _ in range(300)]
    drawn = json.dumps([draws, sorted(r.held()), inputs.pick(seed, 256, 4)])
    assert hashlib.sha256(drawn.encode()).hexdigest() == before["requests"]


def test_operation_counts_are_the_same_as_before():
    tiny, full = tiny_config(D121)["model"], D121["model"]
    assert [UNET.flops_per_frame(tiny, 64, 96), UNET.flops_per_frame(tiny, 64, 96, train=True),
            UNET.flops_per_frame(full, 128, 192),
            UNET.flops_per_frame(full, 128, 192, train=True)] == [
        79_635_456, 229_272_576, 8_384_937_984, 25_000_673_280]
