"""The client runtime: the `Evolu` handle (`client`), the single-writer
`DbWorker` and its command protocol."""
