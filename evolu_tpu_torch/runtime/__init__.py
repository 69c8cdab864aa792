"""The client runtime: the single-writer `DbWorker` and its command protocol."""
