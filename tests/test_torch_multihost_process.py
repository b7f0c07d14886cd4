"""The port's multi-host decode across two real processes: two
``torch.distributed`` (gloo) processes on localhost, ``device="cpu"``, each
decoding its round-robin share of four WAVs, the saved-file manifests
gathered in rank order (the JAX package's ``tests/test_multihost_process.py``
with the port). The children import nothing of JAX."""

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import sys, os, json, time
    sys.path.insert(0, {repo!r})
    pid = int(sys.argv[1]); port = sys.argv[2]; workdir = sys.argv[3]
    import torch
    torch.set_num_threads(1)
    from audio_modem_radio_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address=f"localhost:{{port}}", num_processes=2, process_id=pid)
    assert multihost.process_count() == 2 and multihost.process_index() == pid
    multihost.initialize(coordinator_address=f"localhost:{{port}}", num_processes=2, process_id=pid)  # no-op
    os.chdir(workdir)
    from audio_modem_radio_tpu_torch.assembly import AssemblyRegistry
    from audio_modem_radio_tpu_torch.encoder import encode_file
    if pid == 0:
        wavs = []
        for i in range(4):
            data = bytes(f"multi host file {{i}} ".encode() * 25)
            open(f"m{{i}}.bin", "wb").write(data)
            wavs.append(encode_file(f"m{{i}}.bin", mode="QPSK", symbol_rate=4800))
        json.dump(wavs, open("wavs.json.tmp", "w"))
        os.rename("wavs.json.tmp", "wavs.json")  # the peer never reads a half-written list
    else:
        while not os.path.exists("wavs.json"):
            time.sleep(0.3)
    wavs = json.load(open("wavs.json"))
    assert multihost.partition_files(wavs) == wavs[pid::2]
    saved = multihost.decode_wav_batch_multihost(
        wavs, "QPSK", 4800, registry=AssemblyRegistry(journal_dir=""), recv_dir=f"recv{{pid}}", device="cpu"
    )
    assert len(saved) == 4, (pid, saved)
    assert [p.split(os.sep)[0] for p in saved] == ["recv0", "recv0", "recv1", "recv1"], saved  # rank order
    local = [p for p in saved if p.startswith(f"recv{{pid}}")]
    assert len(local) == 2, (pid, local)
    for p in local:
        assert open(p, "rb").read().startswith(b"multi host file "), p
    leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "audio_modem_radio_tpu.")))
    assert not leaked, leaked
    print(f"proc {{pid}} OK")
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_multihost_decode(tmp_path):
    port = _free_port()
    prog = _CHILD.format(repo=REPO)
    procs = [
        subprocess.Popen([sys.executable, "-c", prog, str(i), str(port), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i} OK" in out
