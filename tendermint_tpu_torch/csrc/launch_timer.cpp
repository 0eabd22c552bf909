// Device time of a kernel launch measured where the launch is made: CUDA
// events recorded on the launch's stream just before and just after it,
// in the same host call. A Python caller that records its own events
// around a launch measures whatever holds it off the interpreter lock
// between the two (other threads of a process that runs a whole net);
// here nothing runs between the records and the launch but the launch.
//
// Nothing here links against CUDA: the caller passes the driver's
// cuEventRecord and the launcher (tm_ladder_verify / _verify_pre of
// ladder.cu) as function pointers, and the events as their handles.
// Built with g++ by chip_smoke.py; tests drive it with host callbacks.
//
// Each returns the launcher's own result (0 when the launch was taken),
// or kRecordFailed + the driver's error when a record failed.

extern "C" {

typedef int (*record_fn)(void *event, void *stream);
typedef int (*verify_fn)(const void *, const void *, const void *,
                         const void *, const void *, void *, int, int, void *);
typedef int (*verify_pre_fn)(const void *, const void *, const void *,
                             const void *, const void *, const void *,
                             const void *, void *, int, int, void *);

static const int kRecordFailed = 1 << 20;

int tm_timed_verify(record_fn record, void *start, void *end,
                    verify_fn launch, const void *pk, const void *rb,
                    const void *sb, const void *hb, const void *consts,
                    void *out, int n, int n_windows, void *stream) {
  int err = record(start, stream);
  if (err != 0) return kRecordFailed + err;
  int rc = launch(pk, rb, sb, hb, consts, out, n, n_windows, stream);
  err = record(end, stream);
  if (rc != 0) return rc;
  return err != 0 ? kRecordFailed + err : 0;
}

int tm_timed_verify_pre(record_fn record, void *start, void *end,
                        verify_pre_fn launch, const void *xnb, const void *yb,
                        const void *ok, const void *rb, const void *sb,
                        const void *hb, const void *consts, void *out, int n,
                        int n_windows, void *stream) {
  int err = record(start, stream);
  if (err != 0) return kRecordFailed + err;
  int rc = launch(xnb, yb, ok, rb, sb, hb, consts, out, n, n_windows, stream);
  err = record(end, stream);
  if (rc != 0) return rc;
  return err != 0 ? kRecordFailed + err : 0;
}

int tm_record_failed_base(void) { return kRecordFailed; }

}  // extern "C"
