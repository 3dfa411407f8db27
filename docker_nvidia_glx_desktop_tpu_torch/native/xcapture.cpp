/* X display capture shim: the ximagesrc/x11vnc-snapfb role (reference
 * SURVEY.md §3.2 capture stage; x11vnc -snapfb entrypoint.sh:123).
 *
 * Grabs the root window with MIT-SHM when available (XShmGetImage — one
 * copy, no socket round-trip per frame) falling back to XGetImage, and
 * converts the 32-bit ZPixmap to tightly-packed RGB for the frame-source
 * abstraction (rfb/source.py XShmSource).
 *
 * Built SEPARATELY from the entropy library because it needs X11 headers
 * that only exist in the container image:
 *   g++ -O2 -shared -fPIC -o xcapture.so xcapture.cpp -lX11 -lXext
 */
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <X11/Xlib.h>
#include <X11/Xutil.h>
#include <X11/extensions/XShm.h>
#include <sys/ipc.h>
#include <sys/shm.h>

extern "C" {

struct XCap {
    Display *dpy;
    Window root;
    int width, height, depth;
    XImage *img;
    XShmSegmentInfo shm;
    int use_shm;
};

void *xcap_open(const char *display_name) {
    Display *dpy = XOpenDisplay(display_name);
    if (!dpy) return nullptr;
    int screen = DefaultScreen(dpy);
    XCap *c = (XCap *)calloc(1, sizeof(XCap));
    c->dpy = dpy;
    c->root = RootWindow(dpy, screen);
    c->width = DisplayWidth(dpy, screen);
    c->height = DisplayHeight(dpy, screen);
    c->depth = DefaultDepth(dpy, screen);

    if (XShmQueryExtension(dpy)) {
        c->img = XShmCreateImage(dpy, DefaultVisual(dpy, screen), c->depth,
                                 ZPixmap, nullptr, &c->shm, c->width,
                                 c->height);
        if (c->img) {
            c->shm.shmid = shmget(IPC_PRIVATE,
                                  (size_t)c->img->bytes_per_line * c->height,
                                  IPC_CREAT | 0600);
            if (c->shm.shmid >= 0) {
                c->shm.shmaddr = c->img->data =
                    (char *)shmat(c->shm.shmid, nullptr, 0);
                c->shm.readOnly = False;
                if (c->shm.shmaddr != (char *)-1 &&
                    XShmAttach(dpy, &c->shm)) {
                    XSync(dpy, False);
                    /* mark for auto-removal once both sides detach */
                    shmctl(c->shm.shmid, IPC_RMID, nullptr);
                    c->use_shm = 1;
                } else {
                    shmctl(c->shm.shmid, IPC_RMID, nullptr);
                }
            }
            if (!c->use_shm) {
                XDestroyImage(c->img);
                c->img = nullptr;
            }
        }
    }
    return c;
}

int xcap_width(void *h) { return ((XCap *)h)->width; }
int xcap_height(void *h) { return ((XCap *)h)->height; }

/* Grab the full root window into rgb_out (width*height*3, row-major).
 * Returns 0 on success. */
int xcap_grab(void *h, uint8_t *rgb_out) {
    XCap *c = (XCap *)h;
    XImage *img;
    if (c->use_shm) {
        if (!XShmGetImage(c->dpy, c->root, c->img, 0, 0, AllPlanes))
            return -1;
        img = c->img;
    } else {
        img = XGetImage(c->dpy, c->root, 0, 0, c->width, c->height,
                        AllPlanes, ZPixmap);
        if (!img) return -1;
    }
    const uint32_t rm = img->red_mask, gm = img->green_mask,
                   bm = img->blue_mask;
    /* fast path: the ubiquitous 32bpp BGRX little-endian layout */
    int fast = (img->bits_per_pixel == 32 && rm == 0xFF0000 &&
                gm == 0x00FF00 && bm == 0x0000FF);
    for (int y = 0; y < c->height; y++) {
        const uint8_t *src =
            (const uint8_t *)img->data + (size_t)y * img->bytes_per_line;
        uint8_t *dst = rgb_out + (size_t)y * c->width * 3;
        if (fast) {
            for (int x = 0; x < c->width; x++) {
                dst[3 * x + 0] = src[4 * x + 2];
                dst[3 * x + 1] = src[4 * x + 1];
                dst[3 * x + 2] = src[4 * x + 0];
            }
        } else {
            const int bpp = img->bits_per_pixel / 8;
            const uint32_t rmax = rm >> __builtin_ctz(rm);
            const uint32_t gmax = gm >> __builtin_ctz(gm);
            const uint32_t bmax = bm >> __builtin_ctz(bm);
            for (int x = 0; x < c->width; x++) {
                uint32_t px = 0;
                memcpy(&px, src + (size_t)bpp * x,
                       bpp < 4 ? bpp : 4);          /* no row over-read */
                /* scale sub-8-bit channels (e.g. RGB565) to full range */
                uint32_t r = (px & rm) >> __builtin_ctz(rm);
                uint32_t g = (px & gm) >> __builtin_ctz(gm);
                uint32_t b = (px & bm) >> __builtin_ctz(bm);
                dst[3 * x + 0] = rmax ? r * 255u / rmax : 0;
                dst[3 * x + 1] = gmax ? g * 255u / gmax : 0;
                dst[3 * x + 2] = bmax ? b * 255u / bmax : 0;
            }
        }
    }
    if (!c->use_shm) XDestroyImage(img);
    return 0;
}

void xcap_close(void *h) {
    XCap *c = (XCap *)h;
    if (c->use_shm) {
        XShmDetach(c->dpy, &c->shm);
        XDestroyImage(c->img);
        shmdt(c->shm.shmaddr);
    }
    XCloseDisplay(c->dpy);
    free(c);
}

}  /* extern "C" */
