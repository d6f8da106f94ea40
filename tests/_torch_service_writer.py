"""A process that writes to a shared sharded corpus: one 'daemon' of
``test_torch_service.py``'s concurrency case, kept in a module of its own
so that a spawned child imports only the store it writes through."""
import importlib


def sharded_daemon_writer(package: str, root: str, tag: int,
                          barrier) -> None:
    """Open the corpus, wait for the other writer, then publish entries and
    revisioned model artifacts for keys overlapping the other's."""
    service = importlib.import_module(f"{package}.service")
    store = service.ShardedConfigStore(root, n_shards=3)
    barrier.wait(timeout=30)
    store.put("sp", f"own{tag}", "hw", config={"X": tag},
              runtime=1.0 + tag, trials=1)
    store.put("sp", "shared", "hw", config={"RT": tag},
              runtime=2.0 - tag, trials=1)
    store.put_model_dict("sp", "shared", "hw",
                         {"format": "repro.tppc_model", "tag": tag},
                         revision=10 + tag)
